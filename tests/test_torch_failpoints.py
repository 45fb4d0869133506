"""The port's failpoint registry (presto_tpu_torch/failpoints) and its
sites: the cases of tests/test_failpoints.py whose site the port has
(the registry and triggers, serde, spill, memory, the worker, the
client and the admin API of a port worker), and the seeded backoff.
The statement tier, the flight recorder and the metrics of the
reference's file wait for their modules (ROADMAP queue 1 items 14c
and 15)."""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu_torch import failpoints as fp
from presto_tpu_torch import types as T
from presto_tpu_torch.failpoints import (FailpointRegistry,
                                         FailpointSpecError,
                                         InjectedConnDrop, InjectedOOM,
                                         parse_config)
from presto_tpu_torch.utils.backoff import Backoff

SF = 0.01


@pytest.fixture(autouse=True)
def _clean_registry():
    torch.set_num_threads(1)
    fp.disarm_all()
    yield
    fp.disarm_all()


def test_armed_flag_tracks_registry():
    assert fp.ARMED is False
    fp.arm("x.site", "delay(0)")
    assert fp.ARMED is True
    assert fp.disarm("x.site") is True
    assert fp.ARMED is False
    assert fp.disarm("x.site") is False  # idempotent


def test_disarmed_sites_never_reach_the_registry(monkeypatch):
    """A disarmed process pays one module-attribute test per site:
    hit() raising proves it is never called."""
    from presto_tpu_torch.serde.pages import deserialize_page, serialize_page

    def boom(*a, **k):  # pragma: no cover - must not be called
        raise AssertionError("hit() called while disarmed")
    monkeypatch.setattr(fp, "hit", boom)
    page = serialize_page([(T.BIGINT, np.arange(4), np.zeros(4, bool))])
    assert list(deserialize_page(page, [T.BIGINT])[0][0]) == [0, 1, 2, 3]


def test_trigger_once_every_after():
    r = FailpointRegistry()
    r.arm("s", "delay(0):once")
    assert [r.evaluate("s") is not None for _ in range(4)] == \
        [True, False, False, False]
    r.arm("s", "delay(0):every(3)")
    assert [r.evaluate("s") is not None for _ in range(7)] == \
        [False, False, True, False, False, True, False]
    r.arm("s", "delay(0):after(2)")
    assert [r.evaluate("s") is not None for _ in range(5)] == \
        [False, False, True, True, True]
    r.arm("s", "delay(0):always")
    assert all(r.evaluate("s") is not None for _ in range(3))


def test_prob_trigger_replays_bit_identically():
    def draw(seed):
        r = FailpointRegistry()
        r.arm("site.a", f"delay(0):prob(0.4,{seed})")
        return [r.evaluate("site.a") is not None for _ in range(64)]
    a, b = draw(42), draw(42)
    assert a == b
    assert any(a) and not all(a)
    assert draw(43) != a


def test_prob_draws_equal_the_reference():
    """The same schedule fires on the same evaluations in both
    packages: prob seeds its PRNG with (seed, site) alike."""
    from presto_tpu.failpoints import FailpointRegistry as RefRegistry
    port, ref = FailpointRegistry(), RefRegistry()
    for r in (port, ref):
        r.arm("exchange.fetch", "delay(0):prob(0.3,11)")
    assert [port.evaluate("exchange.fetch") is not None
            for _ in range(200)] == \
        [ref.evaluate("exchange.fetch") is not None for _ in range(200)]


def test_prob_seed_is_per_site():
    r = FailpointRegistry()
    r.arm("a", "delay(0):prob(0.5,7)")
    r.arm("b", "delay(0):prob(0.5,7)")
    sa = [r.evaluate("a") is not None for _ in range(64)]
    sb = [r.evaluate("b") is not None for _ in range(64)]
    assert sa != sb


def test_fire_sequence_numbers_and_lifetime_totals():
    r = FailpointRegistry()
    r.arm("s", "delay(0):every(2)")
    seqs = [r.evaluate("s") for _ in range(6)]
    assert [x[1] for x in seqs if x is not None] == [1, 2, 3]
    assert r.totals() == {("s", "delay"): 3}
    r.disarm("s")
    assert r.totals() == {("s", "delay"): 3}  # totals survive disarm
    r.arm("s", "delay(0):always")
    assert r.evaluate("s")[1] == 1  # the sequence restarts per arm
    assert r.totals() == {("s", "delay"): 4}


@pytest.mark.parametrize("bad", [
    "nope", "error(NoSuchExc)", "delay", "delay(5,6)", "corrupt_page(1)",
    "error(RuntimeError):sometimes", "delay(5):every", "delay(5):prob(1.5)",
    ""])
def test_spec_parse_errors(bad):
    with pytest.raises((FailpointSpecError, ValueError)):
        fp.parse_spec("s", bad)


def test_config_string_nested_commas_and_whole_string_validation():
    with pytest.raises(FailpointSpecError):
        parse_config("site-without-equals")
    entries = parse_config(
        " a=error(OSError):once , b=delay(5):prob(0.1,7) ,")
    assert entries == [("a", "error(OSError):once"),
                       ("b", "delay(5):prob(0.1,7)")]
    r = FailpointRegistry()
    with pytest.raises(FailpointSpecError):
        r.configure("a=delay(1),b=bogus")
    assert r.armed_count() == 0  # a bad tail arms nothing


def test_env_config_arms_at_import(monkeypatch):
    monkeypatch.setenv(
        "PRESTO_TPU_FAILPOINTS",
        "worker.run_task=delay(1):once,"
        "serde.deserialize=corrupt_page:prob(0.5,9)")
    r = FailpointRegistry()
    armed = fp._configure_from_env(r)
    assert sorted(armed) == ["serde.deserialize", "worker.run_task"]
    assert r.armed_table()["serde.deserialize"].trigger.kind == "prob"
    monkeypatch.delenv("PRESTO_TPU_FAILPOINTS")
    r2 = FailpointRegistry()
    assert fp._configure_from_env(r2) == [] and r2.armed_count() == 0


def test_scratch_registry_never_touches_the_process_armed_flag():
    fp.arm("real.site", "delay(0):always")
    scratch = FailpointRegistry()
    scratch.arm("x", "delay(0)")
    assert fp.ARMED is True
    scratch.disarm_all()
    assert fp.ARMED is True
    assert "real.site" in fp.active()
    fp.disarm_all()
    scratch.arm("y", "delay(0)")
    assert fp.ARMED is False


def test_session_scope_composes_with_concurrent_arms():
    with fp.session_scope("scoped.site=delay(0):once"):
        fp.arm("other.query", "delay(0):always")
    assert "other.query" in fp.active()
    assert "scoped.site" not in fp.active()


def test_overlapping_scopes_on_same_site_cannot_leak():
    a = fp.session_scope("dup.site=error(RuntimeError):always")
    b = fp.session_scope("dup.site=delay(1):always")
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)
    assert fp.active()["dup.site"]["spec"] == "delay(1):always"
    b.__exit__(None, None, None)
    assert "dup.site" not in fp.active() and fp.ARMED is False
    a = fp.session_scope("dup.site=error(RuntimeError):always")
    b = fp.session_scope("dup.site=delay(1):always")
    a.__enter__()
    b.__enter__()
    b.__exit__(None, None, None)
    assert fp.active()["dup.site"]["spec"] == "error(RuntimeError):always"
    a.__exit__(None, None, None)
    assert "dup.site" not in fp.active() and fp.ARMED is False
    with fp.session_scope("dup.site=delay(1):once"):
        fp.arm("dup.site", "oom:always")
    assert fp.active()["dup.site"]["spec"] == "oom:always"


def test_session_scope_applies_and_restores():
    fp.arm("keep.me", "delay(0):always")
    with fp.session_scope("temp.site=error(RuntimeError):once"):
        assert set(fp.active()) == {"keep.me", "temp.site"}
        with fp.session_scope(""):  # falsy: no-op
            assert set(fp.active()) == {"keep.me", "temp.site"}
    assert set(fp.active()) == {"keep.me"}
    with fp.session_scope("keep.me=delay(1):once"):
        assert fp.active()["keep.me"]["spec"] == "delay(1):once"
    assert fp.active()["keep.me"]["spec"] == "delay(0):always"


def test_actions_raise_sleep_and_corrupt():
    fp.arm("s", "error(ConnectionError):always")
    with pytest.raises(ConnectionError):
        fp.hit("s")
    fp.arm("s", "oom:always")
    with pytest.raises(InjectedOOM):
        fp.hit("s")
    fp.arm("s", "drop_conn:always")
    with pytest.raises(InjectedConnDrop):
        fp.hit("s")
    fp.arm("s", "delay(30):always")
    t0 = time.time()
    assert fp.hit("s", b"payload") == b"payload"
    assert time.time() - t0 >= 0.025
    fp.arm("s", "corrupt_page:always")
    blob = bytes(range(64))
    corrupted = fp.hit("s", blob)
    assert corrupted != blob and len(corrupted) == len(blob)
    assert fp.hit("s", corrupted) == blob  # XOR: involutive
    assert fp.hit("s", None) is None


def test_corrupt_page_fails_checksum_and_clean_reread_recovers():
    from presto_tpu_torch.serde.pages import deserialize_page, serialize_page
    page = serialize_page([(T.BIGINT, np.arange(16), np.zeros(16, bool))])
    fp.arm("serde.deserialize", "corrupt_page:once")
    with pytest.raises(ValueError, match="checksum"):
        deserialize_page(page, [T.BIGINT])
    assert list(deserialize_page(page, [T.BIGINT])[0][0]) == list(range(16))


def test_serialize_site_corrupts_after_the_checksum():
    from presto_tpu_torch.serde.pages import deserialize_page, serialize_page
    fp.arm("serde.serialize", "corrupt_page:once")
    page = serialize_page([(T.BIGINT, np.arange(16), np.zeros(16, bool))])
    with pytest.raises(ValueError, match="checksum"):
        deserialize_page(page, [T.BIGINT])


def test_memory_reserve_oom_speaks_reservation_error():
    from presto_tpu_torch.exec.memory import (MemoryPool,
                                              MemoryReservationError)
    pool = MemoryPool(1 << 20)
    fp.arm("memory.reserve", "oom:once")
    with pytest.raises(MemoryReservationError, match="failpoint"):
        pool.reserve("q1", 128)
    pool.reserve("q1", 128)  # recovered; the pool is untouched
    assert pool.reserved_bytes == 128


def test_spill_write_and_read_failpoints(tmp_path):
    from presto_tpu_torch.block import batch_from_numpy
    from presto_tpu_torch.exec.spill import _HostRows
    rows = _HostRows([T.BIGINT], disk_dir=str(tmp_path),
                     disk_threshold_bytes=1)
    batch = batch_from_numpy([T.BIGINT], [np.arange(8)],
                             [np.zeros(8, bool)], device="cpu")
    fp.arm("spill.write", "error(OSError):once")
    with pytest.raises(OSError, match="failpoint"):
        rows.append(batch, None)  # the flush past the threshold
    rows.append(batch, None)  # the retry flushes clean
    fp.arm("spill.read", "error(OSError):once")
    with pytest.raises(OSError, match="failpoint"):
        rows.columns()
    cols, _nulls = rows.columns()
    assert len(cols[0]) >= 8
    rows.close()


def test_spilled_aggregation_through_an_armed_memory_pool():
    """run_query's admission reserve meets the memory.reserve site:
    the injected oom fails the query with the pool's own error, and
    the next run succeeds."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.memory import (MemoryPool,
                                              MemoryReservationError)
    from presto_tpu_torch.sql import plan_sql
    pool = MemoryPool(1 << 30)
    plan = plan_sql("SELECT count(*) AS n FROM nation")
    fp.arm("memory.reserve", "oom:once")
    with pytest.raises(MemoryReservationError):
        run_query(plan, sf=SF, device="cpu", memory_pool=pool)
    assert run_query(plan, sf=SF, device="cpu",
                     memory_pool=pool).rows() == [(25,)]


def test_sites_catalog_equals_the_reference():
    from presto_tpu.failpoints import SITES as REF_SITES
    assert fp.SITES == REF_SITES


# -- a port worker's admin API and sites ---------------------------------

@pytest.fixture(scope="module")
def worker():
    from presto_tpu_torch.server import TpuWorkerServer
    w = TpuWorkerServer(sf=SF, device="cpu").start()
    yield w
    w.stop()


def _http(method, url, body=None):
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_admin_api_round_trip(worker):
    base = worker.url
    code, doc = _http("POST", f"{base}/v1/failpoint",
                      {"site": "adm.site",
                       "spec": "error(RuntimeError):every(5)"})
    assert code == 200 and "adm.site" in doc["active"]
    code, doc = _http("GET", f"{base}/v1/failpoint")
    assert code == 200
    assert doc["armed"]["adm.site"]["trigger"] == "every(5)"
    assert "exchange.fetch" in doc["sites"]
    code, doc = _http("DELETE", f"{base}/v1/failpoint/adm.site")
    assert code == 200 and doc["disarmed"] == ["adm.site"]
    code, doc = _http("POST", f"{base}/v1/failpoint",
                      {"config": "a.b=delay(1):once,c.d=oom"})
    assert code == 200 and sorted(doc["armed"]) == ["a.b", "c.d"]
    code, doc = _http("DELETE", f"{base}/v1/failpoint")
    assert code == 200 and sorted(doc["disarmed"]) == ["a.b", "c.d"]
    assert fp.armed_count() == 0


def test_admin_api_rejects_bad_spec(worker):
    code, doc = _http("POST", f"{worker.url}/v1/failpoint",
                      {"site": "s", "spec": "explode(9)"})
    assert code == 400 and "unknown action" in doc["error"]
    code, doc = _http("POST", f"{worker.url}/v1/failpoint", {"nope": 1})
    assert code == 400


def test_worker_task_session_property_schedule(worker):
    """The `failpoints` session property arms a schedule for one task
    and the registry is restored after it."""
    from presto_tpu_torch.server import WorkerClient
    from presto_tpu_torch.sql import plan_sql
    client = WorkerClient(worker.url)
    client.submit("fp-sess-1", plan_sql("SELECT 1"), sf=SF,
                  session={"failpoints":
                           "worker.run_task=error(RuntimeError):always"})
    info = client.wait("fp-sess-1", timeout=30)
    assert info["state"] == "FAILED"
    assert "failpoint worker.run_task" in info["error"]
    deadline = time.time() + 2.0
    while fp.ARMED and time.time() < deadline:
        time.sleep(0.02)
    assert fp.ARMED is False
    client.abort("fp-sess-1")


def test_exchange_serve_error_answers_500(worker):
    from presto_tpu_torch.server import WorkerClient
    from presto_tpu_torch.sql import plan_sql
    client = WorkerClient(worker.url)
    client.submit("fp-serve-1", plan_sql("SELECT 1"), sf=SF)
    assert client.wait("fp-serve-1", 30)["state"] == "FINISHED"
    fp.arm("exchange.serve", "error(RuntimeError):once")
    with pytest.raises(urllib.error.HTTPError) as ei:
        client.fetch_results("fp-serve-1", [T.INTEGER])
    assert ei.value.code == 500
    (v, _), = client.fetch_results("fp-serve-1", [T.INTEGER])
    assert list(v) == [1]
    client.abort("fp-serve-1")


def test_client_request_drop_conn_retries_with_backoff(worker):
    """drop_conn on the client hop is an injected stale keep-alive
    socket: the request succeeds on the fresh-connection retry."""
    from presto_tpu_torch.server import WorkerClient
    fp.arm("client.request", "drop_conn:once")
    assert WorkerClient(worker.url).info()["state"] == "ACTIVE"
    assert fp.active()["client.request"]["fires"] == 1


# -- backoff --------------------------------------------------------------

def test_backoff_deterministic_bounded_and_growing():
    a = Backoff(base_s=0.05, cap_s=1.0, factor=2.0, jitter=0.5, seed="t")
    b = Backoff(base_s=0.05, cap_s=1.0, factor=2.0, jitter=0.5, seed="t")
    da = [a.next_delay() for _ in range(10)]
    assert da == [b.next_delay() for _ in range(10)]
    assert all(0.0 <= d <= 1.0 * 1.5 for d in da)
    raw = [min(1.0, 0.05 * 2.0 ** k) for k in range(10)]
    assert all(abs(d - r) <= 0.5 * r + 1e-9 for d, r in zip(da, raw))
    assert Backoff(seed="other").next_delay() != da[0]


def test_backoff_preview_does_not_consume():
    b = Backoff(seed=1)
    peek = b.preview(3)
    assert [b.next_delay() for _ in range(3)] == peek


def test_backoff_delays_equal_the_reference():
    from presto_tpu.utils.backoff import Backoff as RefBackoff
    a, b = Backoff(seed="task-7"), RefBackoff(seed="task-7")
    assert [a.next_delay() for _ in range(8)] == \
        [b.next_delay() for _ in range(8)]
