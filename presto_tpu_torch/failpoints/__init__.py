"""failpoints: deterministic fault injection at named sites.

Counterpart of presto_tpu/failpoints (the registry, `parse_spec`,
`parse_config`, `hit`, `arm`/`disarm`/`configure`, `session_scope`
and the admin documents of ``/v1/failpoint``): named sites in the hot
paths, free until armed, driven by an expression grammar so that a
test can make exactly the k-th page pull fail, run after run. The
fired fault is counted per (site, action), exported as
``presto_tpu_failpoint_hits_total{site,action}`` on both tiers'
/v1/metrics, and logged as a flight-recorder ``failpoint`` event
cross-linked to the ambient trace.

The site idiom (a disarmed hot path pays one module-attribute test)::

    from .. import failpoints
    if failpoints.ARMED:
        failpoints.hit("exchange.fetch")

``hit(site, payload=None)`` returns ``payload`` untouched (no fault),
returns a corrupted copy (``corrupt_page``), sleeps (``delay``/
``hang``), or raises (``error``/``oom``/``drop_conn``).

Actions:    ``error(ExcName)`` | ``delay(ms)`` | ``hang(ms)`` |
            ``corrupt_page`` | ``oom`` | ``drop_conn``
Triggers:   ``always`` | ``once`` | ``every(n)`` | ``after(n)`` |
            ``prob(p[,seed])``
Spec:       ``action[:trigger]`` (the trigger defaults to ``always``)
Config:     ``site=spec,site=spec,...``: the grammar of the
            ``PRESTO_TPU_FAILPOINTS`` environment variable, the
            ``failpoints`` session property and ``POST /v1/failpoint``.

``prob`` draws from a ``random.Random`` seeded by ``(seed, site)`` and
every other trigger is a function of the site's evaluation count, so
a fixed schedule replays the same faults. The registry is one per
process.
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict, List, Optional, Tuple

from .sites import SITES, sites_by_layer
from ..utils.locks import OrderedLock

__all__ = ["ARMED", "hit", "arm", "disarm", "disarm_all", "configure",
           "active", "failpoint_totals", "armed_count", "session_scope",
           "parse_spec", "parse_config",
           "admin_get_doc", "admin_post", "admin_delete",
           "FailpointError", "InjectedConnDrop", "InjectedOOM",
           "FailpointSpecError", "SITES", "sites_by_layer"]

# The one module-level bool every site reads. True iff >= 1 site is
# armed; flipped only by the registry (under its lock), read lock-free
# on hot paths -- a stale read costs one extra no-op evaluate() at
# worst, never a missed *armed* fault for the thread that armed it.
ARMED: bool = False


class FailpointError(RuntimeError):
    """Default injected exception class (``error`` with no name)."""


class InjectedConnDrop(ConnectionResetError):
    """``drop_conn``: a ConnectionError subclass, so client-side retry
    machinery treats it exactly like a real peer reset; server-side
    handlers catch it and close the socket without a response."""


class InjectedOOM(MemoryError):
    """``oom``: sites translate this into their native out-of-memory
    surface (MemoryPool.reserve -> MemoryReservationError)."""


class FailpointSpecError(ValueError):
    """Unparseable action/trigger/config expression."""


# exception classes `error(Name)` may name: the engine's retry paths
# discriminate by type, so injection must be able to speak each one
_EXC_CLASSES = {
    "FailpointError": FailpointError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "IOError": OSError,
    "OSError": OSError,
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "TimeoutError": TimeoutError,
    "KeyError": KeyError,
    "MemoryError": MemoryError,
}

_ACTIONS = ("error", "delay", "hang", "corrupt_page", "oom", "drop_conn")
_TRIGGERS = ("always", "once", "every", "after", "prob")


class _Action:
    """Parsed action: kind + argument (exception class or millis)."""

    def __init__(self, kind: str, arg=None):
        self.kind = kind
        self.arg = arg

    def __repr__(self):
        if self.kind == "error":
            return f"error({self.arg.__name__})"
        if self.kind in ("delay", "hang"):
            return f"{self.kind}({int(self.arg)})"
        return self.kind


class _Trigger:
    """Parsed trigger + its deterministic decision function. State is
    the owning _Armed's evaluation counter (and, for ``prob``, a PRNG
    seeded by (seed, site)); should_fire is called under the registry
    lock, so the count/PRNG advance atomically per evaluation."""

    def __init__(self, kind: str, n: int = 0, p: float = 0.0,
                 seed: int = 0, site: str = ""):
        self.kind = kind
        self.n = n
        self.p = p
        self.seed = seed
        self._rng = random.Random(f"{seed}:{site}") \
            if kind == "prob" else None

    def should_fire(self, evals: int) -> bool:
        """`evals` is 1-based: the count INCLUDING this evaluation."""
        if self.kind == "always":
            return True
        if self.kind == "once":
            return evals == 1
        if self.kind == "every":
            return evals % max(self.n, 1) == 0
        if self.kind == "after":
            return evals > self.n
        return self._rng.random() < self.p  # prob

    def __repr__(self):
        if self.kind in ("every", "after"):
            return f"{self.kind}({self.n})"
        if self.kind == "prob":
            return f"prob({self.p},{self.seed})"
        return self.kind


def _parse_call(expr: str) -> Tuple[str, List[str]]:
    """``name`` or ``name(a,b)`` -> (name, [args])."""
    expr = expr.strip()
    if "(" not in expr:
        return expr, []
    if not expr.endswith(")"):
        raise FailpointSpecError(f"unbalanced parens in {expr!r}")
    name, _, inner = expr[:-1].partition("(")
    args = [a.strip() for a in inner.split(",")] if inner.strip() else []
    return name.strip(), args


def _parse_action(expr: str) -> _Action:
    name, args = _parse_call(expr)
    if name not in _ACTIONS:
        raise FailpointSpecError(
            f"unknown action {name!r} (one of {', '.join(_ACTIONS)})")
    if name == "error":
        exc_name = args[0] if args else "FailpointError"
        exc = _EXC_CLASSES.get(exc_name)
        if exc is None:
            raise FailpointSpecError(
                f"unknown exception class {exc_name!r} "
                f"(one of {', '.join(sorted(_EXC_CLASSES))})")
        return _Action("error", exc)
    if name in ("delay", "hang"):
        if len(args) != 1:
            raise FailpointSpecError(f"{name} takes exactly one arg (ms)")
        return _Action(name, float(args[0]))
    if args:
        raise FailpointSpecError(f"action {name} takes no arguments")
    return _Action(name)


def _parse_trigger(expr: str, site: str) -> _Trigger:
    name, args = _parse_call(expr)
    if name not in _TRIGGERS:
        raise FailpointSpecError(
            f"unknown trigger {name!r} (one of {', '.join(_TRIGGERS)})")
    if name in ("every", "after"):
        if len(args) != 1:
            raise FailpointSpecError(f"{name} takes exactly one arg (n)")
        return _Trigger(name, n=int(args[0]), site=site)
    if name == "prob":
        if len(args) not in (1, 2):
            raise FailpointSpecError("prob takes (p) or (p, seed)")
        p = float(args[0])
        if not 0.0 <= p <= 1.0:
            raise FailpointSpecError(f"prob p={p} outside [0, 1]")
        seed = int(args[1]) if len(args) == 2 else 0
        return _Trigger("prob", p=p, seed=seed, site=site)
    if args:
        raise FailpointSpecError(f"trigger {name} takes no arguments")
    return _Trigger(name, site=site)


def parse_spec(site: str, spec: str) -> Tuple[_Action, _Trigger]:
    """``action[:trigger]`` -> (_Action, _Trigger). The trigger PRNG is
    seeded per (seed, site), so identical specs on different sites draw
    independent -- but each individually reproducible -- sequences."""
    spec = spec.strip()
    if not spec:
        raise FailpointSpecError("empty failpoint spec")
    action_s, sep, trigger_s = spec.partition(":")
    action = _parse_action(action_s)
    trigger = _parse_trigger(trigger_s if sep else "always", site)
    return action, trigger


def parse_config(config: str) -> List[Tuple[str, str]]:
    """``site=action:trigger,site=...`` -> [(site, spec)]. Commas split
    entries only at paren depth zero (``prob(0.1,42)`` stays whole)."""
    entries: List[Tuple[str, str]] = []
    depth = 0
    cur: List[str] = []
    parts: List[str] = []
    for ch in config or "":
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    for part in parts:
        part = part.strip()
        if not part:
            continue
        site, sep, spec = part.partition("=")
        if not sep or not site.strip() or not spec.strip():
            raise FailpointSpecError(
                f"bad failpoint entry {part!r} (want site=action:trigger)")
        entries.append((site.strip(), spec.strip()))
    return entries


class _Armed:
    """One armed site: spec + live trigger state. Mutated only under
    the registry lock."""

    def __init__(self, site: str, spec: str, action: _Action,
                 trigger: _Trigger):
        self.site = site
        self.spec = spec
        self.action = action
        self.trigger = trigger
        self.evals = 0  # evaluations since armed
        self.fires = 0  # faults fired since armed
        # scoped-arm bookkeeping (apply_scoped/revert_scoped): the
        # entry this one displaced, and whether the scope that
        # installed THIS entry has exited (a dead entry must never be
        # resurrected by a later-exiting overlapping scope)
        self.prev: Optional["_Armed"] = None
        self.dead = False

    def doc(self) -> dict:
        return {"spec": self.spec, "action": repr(self.action),
                "trigger": repr(self.trigger),
                "evals": self.evals, "fires": self.fires}


class FailpointRegistry:
    """Process-wide armed-site table + lifetime fire counters.

    Lifetime counters survive disarm (the /v1/metrics contract: a
    counter never decreases); trigger state resets on re-arm."""

    # request handlers, task threads and engine threads all evaluate
    # concurrently; every write rides the one lock (tpulint C001)
    _GUARDED_BY = {"_lock": ("_armed", "_totals")}

    # request handlers, task threads and engine threads all evaluate
    # concurrently; every write rides the one lock

    def __init__(self):
        self._armed: Dict[str, _Armed] = {}
        # lifetime (site, action-kind) -> fired count
        self._totals: Dict[Tuple[str, str], int] = {}
        self._lock = OrderedLock("failpoints.FailpointRegistry._lock")

    def arm(self, site: str, spec: str) -> None:
        action, trigger = parse_spec(site, spec)
        with self._lock:
            self._armed[site] = _Armed(site, spec, action, trigger)
            self._sync_locked()

    def disarm(self, site: str) -> bool:
        with self._lock:
            found = self._armed.pop(site, None) is not None
            self._sync_locked()
        return found

    def disarm_all(self) -> None:
        with self._lock:
            self._armed = {}
            self._sync_locked()

    def configure(self, config: str) -> List[str]:
        """Arm every entry of a config string; returns the armed site
        names. Parses the WHOLE string before arming anything, so a
        trailing typo cannot leave a half-applied schedule."""
        parsed = [(site, spec, *parse_spec(site, spec))
                  for site, spec in parse_config(config)]
        with self._lock:
            for site, spec, action, trigger in parsed:
                self._armed[site] = _Armed(site, spec, action, trigger)
            self._sync_locked()
        return [site for site, _spec, _a, _t in parsed]

    def _sync_locked(self) -> None:
        # only the PROCESS registry drives the module-level fast gate:
        # scratch instances (tests, tools) must not flip sites armed on
        # the singleton on or off
        global ARMED
        if globals().get("_REGISTRY") is self:
            ARMED = bool(self._armed)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {site: a.doc() for site, a in self._armed.items()}

    def apply_scoped(self, config: str) -> Dict[str, "_Armed"]:
        """Arm a config string, returning {site: the _Armed THIS scope
        installed} -- revert_scoped's undo log. Each installed entry
        chains to the one it displaced (`prev`), so scoping is per
        SITE, not a whole-table swap: two queries' disjoint schedules
        compose, and overlapping scopes on the SAME site unwind safely
        in either exit order (last-writer-wins only while both are
        live)."""
        parsed = [(site, spec, *parse_spec(site, spec))
                  for site, spec in parse_config(config)]
        with self._lock:
            saved: Dict[str, _Armed] = {}
            for site, spec, action, trigger in parsed:
                installed = _Armed(site, spec, action, trigger)
                # a site repeated WITHIN one config collapses: the
                # scope's own earlier entry must not be resurrected
                installed.prev = saved[site].prev if site in saved \
                    else self._armed.get(site)
                saved[site] = installed
                self._armed[site] = installed
            self._sync_locked()
        return saved

    def revert_scoped(self, saved: Dict[str, "_Armed"]) -> None:
        """Undo apply_scoped: for each site, mark this scope's entry
        dead; if it is still the live one, restore the nearest
        still-live ancestor (or pop). An entry someone ELSE armed
        meanwhile stands, and a dead entry is never resurrected by a
        later-exiting overlapping scope -- so no per-query schedule
        can outlive every scope that armed it."""
        with self._lock:
            for site, installed in saved.items():
                installed.dead = True
                if self._armed.get(site) is not installed:
                    continue  # re-armed by someone else: theirs stands
                prev = installed.prev
                while prev is not None and prev.dead:
                    prev = prev.prev
                if prev is None:
                    self._armed.pop(site, None)
                else:
                    self._armed[site] = prev
            self._sync_locked()

    def armed_table(self) -> Dict[str, "_Armed"]:
        with self._lock:
            return dict(self._armed)

    def totals(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._totals)

    def armed_count(self) -> int:
        with self._lock:
            return len(self._armed)

    def evaluate(self, site: str) -> Optional[Tuple[_Action, int]]:
        """One site evaluation: advance trigger state; (action, seq)
        when the fault fires, else None. seq is the site's 1-based
        fired-fault ordinal since arming (the fault-sequence id chaos
        schedules replay)."""
        with self._lock:
            armed = self._armed.get(site)
            if armed is None:
                return None
            armed.evals += 1
            if not armed.trigger.should_fire(armed.evals):
                return None
            armed.fires += 1
            key = (site, armed.action.kind)
            self._totals[key] = self._totals.get(key, 0) + 1
            return armed.action, armed.fires


_REGISTRY = FailpointRegistry()


def _configure_from_env(registry: FailpointRegistry) -> List[str]:
    """Arm PRESTO_TPU_FAILPOINTS on `registry` (the import-time hook,
    split out so tests drive it without a fresh interpreter). Zero-cost
    when unset; ARMED stays False."""
    config = os.environ.get("PRESTO_TPU_FAILPOINTS")
    return registry.configure(config) if config else []


_configure_from_env(_REGISTRY)


def _corrupt(payload: bytes) -> bytes:
    """Deterministic corruption: XOR one mid-payload byte (past the
    21-byte SerializedPage header when the buffer has one, so headers
    parse and the CHECKSUM is what catches it -- the validation path
    under test)."""
    if not payload:
        return b"\xff"
    buf = bytearray(payload)
    idx = 21 + (len(buf) - 21) // 2 if len(buf) > 21 else len(buf) // 2
    buf[idx] ^= 0xFF
    return bytes(buf)


def _record_fire(site: str, action, seq: int) -> None:
    """The flight-recorder ``failpoint`` event of one fired fault,
    cross-linked to the ambient trace (the history archive counts a
    query's by it)."""
    from ..server.flight_recorder import record_event
    from ..server.tracing import current_context
    ctx = current_context()
    record_event("failpoint", site=site, action=action.kind, seq=seq,
                 trace=ctx.trace_id if ctx is not None else None)


def hit(site: str, payload=None):
    """Evaluate `site`; perform the armed fault when its trigger fires.
    Returns `payload` (corrupted for ``corrupt_page``); raises for
    ``error``/``oom``/``drop_conn``; sleeps for ``delay``/``hang``.
    Call behind an ``if failpoints.ARMED:`` guard -- the guard, not
    this function, is the disarmed hot path."""
    fired = _REGISTRY.evaluate(site)
    if fired is None:
        return payload
    action, seq = fired
    _record_fire(site, action, seq)
    if action.kind == "error":
        raise action.arg(f"failpoint {site} (injected, fire #{seq})")
    if action.kind in ("delay", "hang"):
        time.sleep(float(action.arg) / 1000.0)
        return payload
    if action.kind == "corrupt_page":
        return _corrupt(payload) if isinstance(payload, (bytes, bytearray,
                                                         memoryview)) \
            else payload
    if action.kind == "oom":
        raise InjectedOOM(
            f"failpoint {site}: injected out-of-memory (fire #{seq})")
    # drop_conn
    raise InjectedConnDrop(
        f"failpoint {site}: injected connection drop (fire #{seq})")


# -- module-level registry facade ---------------------------------------

def arm(site: str, spec: str) -> None:
    _REGISTRY.arm(site, spec)


def disarm(site: str) -> bool:
    return _REGISTRY.disarm(site)


def disarm_all() -> None:
    _REGISTRY.disarm_all()


def configure(config: str) -> List[str]:
    return _REGISTRY.configure(config)


def active() -> Dict[str, dict]:
    """{site: {spec, action, trigger, evals, fires}} of armed sites."""
    return _REGISTRY.snapshot()


def failpoint_totals() -> Dict[Tuple[str, str], int]:
    """Lifetime fired-fault counts per (site, action kind) -- the
    /v1/metrics ``presto_tpu_failpoint_hits_total`` source."""
    return _REGISTRY.totals()


def armed_count() -> int:
    return _REGISTRY.armed_count()


class session_scope:
    """Context manager applying a ``failpoints`` session-property spec
    for one query's execution scope, reverting ON EXIT exactly the
    sites it configured (so a per-query schedule cannot leak into the
    next query, and CONCURRENT queries' scopes compose instead of
    clobbering each other -- only the same site armed by two live
    scopes is last-writer-wins). Falsy spec = no-op. Lifetime fire
    counters are never restored -- counters never decrease.

    The registry stays PROCESS-WIDE (the fail-rs/gofail model): the
    scope bounds a schedule's LIFETIME, not which query trips it -- a
    concurrent query passing an armed site while the scope is live
    evaluates it too. Drivers wanting strict isolation serialize their
    fault-injected queries."""

    def __init__(self, spec: Optional[str]):
        self.spec = spec or ""
        self._saved: Optional[Dict[str, _Armed]] = None

    def __enter__(self):
        if self.spec:
            self._saved = _REGISTRY.apply_scoped(self.spec)
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            _REGISTRY.revert_scoped(self._saved)
        return False


# -- admin API document builders (shared by both tiers' handlers) -------

def admin_get_doc() -> dict:
    """``GET /v1/failpoint``: armed table + lifetime totals + the
    committed site catalog."""
    return {
        "armed": active(),
        "hits": {f"{site}|{action}": n
                 for (site, action), n in sorted(failpoint_totals().items())},
        "sites": {name: {"layer": layer, "description": desc}
                  for name, (layer, desc) in sorted(SITES.items())},
    }


def admin_post(body: dict) -> Tuple[dict, int]:
    """``POST /v1/failpoint``: ``{"site": ..., "spec": ...}`` arms one
    site; ``{"config": "site=spec,..."}`` arms a whole schedule.
    Returns (response doc, HTTP status)."""
    try:
        if "config" in body:
            armed = configure(str(body["config"]))
        elif "site" in body and "spec" in body:
            arm(str(body["site"]), str(body["spec"]))
            armed = [str(body["site"])]
        else:
            return ({"error": "want {site, spec} or {config}"}, 400)
    except (FailpointSpecError, ValueError) as e:
        return ({"error": f"{type(e).__name__}: {e}"}, 400)
    return ({"armed": armed, "active": active()}, 200)


def admin_delete(site: Optional[str]) -> dict:
    """``DELETE /v1/failpoint[/{site}]``: disarm one site (or all)."""
    if site:
        return {"disarmed": [site] if disarm(site) else []}
    before = sorted(active())
    disarm_all()
    return {"disarmed": before}
