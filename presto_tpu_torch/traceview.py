"""ASCII waterfall rendering for stitched distributed traces.

Counterpart of presto_tpu/traceview.py, copied whole (pure).

The consumer of server/tracing.py's one-trace-per-query documents
(``GET /v1/trace/{queryId}``): build the span tree from parentId edges,
render a fixed-width waterfall aligned to the trace's own time axis,
and attribute the critical path -- walked BACKWARD from the trace's
last-ending moment, so each interval of wall time is owned by the span
that was actually running latest (children own their windows, gaps
between children belong to the parent). The stage with the most
attributed time is named explicitly: the first question every perf
investigation asks (Flare's compile-vs-execute split and the GPU-Presto
kernel-time attribution are both one glance at this line).

Spans are the exported dicts {traceId, spanId, parentId, name, startUs,
endUs, attributes}. Orphans (a parentId missing from the trace -- a
partial stitch, e.g. a worker whose final status poll was lost) render
as extra roots rather than disappearing: an incomplete trace should
LOOK incomplete, not wrong.

Used by cli.py --trace.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["build_tree", "critical_path", "critical_path_summary",
           "fetch_trace", "render_waterfall"]


def fetch_trace(url: str, query_id: Optional[str] = None,
                timeout: float = 10.0) -> dict:
    """GET a stitched trace document: `url` is the full
    ``/v1/trace/{id}`` URL, or a coordinator/worker base URL with
    `query_id` supplied. The one fetch path every consumer (cli
    --trace) shares; raises on HTTP/parse
    errors so each caller decides how a missing trace degrades."""
    import json
    import urllib.request
    if query_id is not None:
        url = f"{url.rstrip('/')}/v1/trace/{query_id}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def build_tree(spans: List[dict]) -> Tuple[List[dict], Dict[str, List[dict]]]:
    """(roots, children-by-spanId), both start-ordered. A span whose
    parentId is absent from the trace counts as a root (see module
    docstring: partial stitches stay visible)."""
    ids = {s["spanId"] for s in spans}
    roots: List[dict] = []
    children: Dict[str, List[dict]] = {}
    for s in spans:
        pid = s.get("parentId")
        if pid is not None and pid in ids and pid != s["spanId"]:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)
    order = lambda s: (s["startUs"], -s["endUs"])  # noqa: E731

    def reach(from_ids: List[str], seen: set) -> None:
        while from_ids:
            sid = from_ids.pop()
            if sid in seen:
                continue
            seen.add(sid)
            from_ids.extend(k["spanId"] for k in children.get(sid, ()))

    # parentId cycles (a buggy/foreign worker's shipped spans -- stitch
    # validates ids and timestamps, not edges) leave spans reachable
    # from no root; break each cycle by promoting its earliest span,
    # dropping that one edge, so malformed traces render degraded (the
    # module promise) instead of crashing or losing spans
    seen: set = set()
    reach([s["spanId"] for s in roots], seen)
    unreached = [s for s in spans if s["spanId"] not in seen]
    while unreached:
        promote = min(unreached, key=order)
        children[promote["parentId"]].remove(promote)
        roots.append(promote)
        reach([promote["spanId"]], seen)
        unreached = [s for s in unreached if s["spanId"] not in seen]
    roots.sort(key=order)
    for kids in children.values():
        kids.sort(key=order)
    return roots, children


def critical_path(spans: List[dict]) -> List[Tuple[dict, int]]:
    """[(span, attributed_us)] -- the spans on the trace's critical
    path with the wall time each one owns.

    Backward walk from the last-ending root: within a span's window the
    child running latest owns that stretch (recursively), and stretches
    no child covers belong to the span itself. Every microsecond of the
    root's window is attributed exactly once, so the entries sum to the
    trace wall (modulo child intervals leaking outside the parent's,
    which are clipped)."""
    roots, children = build_tree(spans)
    if not roots:
        return []
    # multiple roots (an engine-only trace of bare stage spans, or a
    # partial stitch) walk under one virtual root spanning the whole
    # trace, so attribution still covers every interval
    virtual = {"spanId": "", "name": "",
               "startUs": min(s["startUs"] for s in spans),
               "endUs": max(s["endUs"] for s in spans)}
    children[""] = roots
    attributed: Dict[str, int] = {}
    touched: List[dict] = []

    def touch(s: dict, us: int) -> None:
        if us <= 0 or s is virtual:
            return
        if s["spanId"] not in attributed:
            attributed[s["spanId"]] = 0
            touched.append(s)
        attributed[s["spanId"]] += us

    def walk(span: dict, lo: int, hi: int) -> None:
        cur = hi
        # span.kind=state spans annotate their parent's window (a
        # second decomposition of the same time); letting them compete
        # would shadow the real work tree with e.g. query.running
        kids = sorted((k for k in children.get(span["spanId"], ())
                       if k["startUs"] < cur and k["endUs"] > lo
                       and k.get("attributes", {}).get("span.kind")
                       != "state"),
                      key=lambda k: k["endUs"])
        for kid in reversed(kids):          # latest-ending child first
            k_end = min(kid["endUs"], cur)
            if k_end <= lo:
                break
            touch(span, cur - k_end)        # gap after kid: span's own
            k_lo = max(kid["startUs"], lo)
            walk(kid, k_lo, k_end)
            cur = k_lo
            if cur <= lo:
                break
        touch(span, cur - lo)               # leading stretch, if any

    walk(virtual, virtual["startUs"], virtual["endUs"])
    touched.sort(key=lambda s: s["startUs"])
    return [(s, attributed[s["spanId"]]) for s in touched]


def critical_path_summary(spans: List[dict],
                          path: Optional[List[tuple]] = None) -> str:
    """Two lines: the critical-path chain (start-ordered) and the one
    stage on it owning the most wall time, with its share. `path` takes
    a precomputed `critical_path(spans)` so callers that already walked
    the tree (render_waterfall) don't attribute twice."""
    path = critical_path(spans) if path is None else path
    if not path:
        return "critical path: (empty trace)"
    wall = max(s["endUs"] for s in spans) - min(s["startUs"] for s in spans)
    names = [s["name"] for s, _ in path]
    if len(names) > 8:
        names = names[:8] + [f"... (+{len(names) - 8} more)"]
    hot, hot_us = max(path, key=lambda e: e[1])
    share = (100.0 * hot_us / wall) if wall > 0 else 0.0
    return (f"critical path: {' > '.join(names)}\n"
            f"critical-path stage: {hot['name']} "
            f"({hot_us / 1000.0:.1f}ms attributed, {share:.0f}% of wall)")


def render_waterfall(doc: dict, width: int = 72) -> str:
    """The trace document -> an ASCII waterfall: one row per span in
    tree order, a bar positioned on the trace's time axis, duration,
    and a ``*`` on every critical-path span; the critical-path summary
    closes the rendering."""
    spans = doc.get("spans") or []
    if not spans:
        return f"trace {doc.get('traceId', '?')}: no spans"
    t0 = min(s["startUs"] for s in spans)
    t1 = max(s["endUs"] for s in spans)
    wall = max(1, t1 - t0)
    path = critical_path(spans)
    on_path = {s["spanId"] for s, _ in path}
    roots, children = build_tree(spans)
    depth_of: Dict[str, int] = {}
    stack = [(r, 0) for r in roots]
    while stack:
        s, d = stack.pop()
        depth_of[s["spanId"]] = d
        stack.extend((k, d + 1) for k in children.get(s["spanId"], ()))
    name_w = min(44, max(len(s["name"]) + 2 * depth_of[s["spanId"]]
                         for s in spans) + 2)
    bar_w = max(20, width - name_w)
    lines = [f"trace {doc.get('traceId', '?')} -- {len(spans)} span(s), "
             f"{wall / 1000.0:.1f}ms wall"
             + (f", query {doc['queryId']}" if doc.get("queryId") else "")]

    def emit(s: dict, depth: int) -> None:
        lo = int(bar_w * (s["startUs"] - t0) / wall)
        hi = max(lo + 1, int(round(bar_w * (s["endUs"] - t0) / wall)))
        bar = " " * lo + "#" * (hi - lo)
        label = ("  " * depth + s["name"])[:name_w].ljust(name_w)
        dur = (s["endUs"] - s["startUs"]) / 1000.0
        mark = " *" if s["spanId"] in on_path else ""
        lines.append(f"{label}|{bar.ljust(bar_w)}| {dur:9.1f}ms{mark}")
        for kid in children.get(s["spanId"], ()):
            emit(kid, depth + 1)

    for root in roots:
        emit(root, 0)
    lines.append(critical_path_summary(spans, path=path))
    return "\n".join(lines)
