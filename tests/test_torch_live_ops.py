"""The port's live telemetry daemon (``torchdistx_tpu_torch.observe.httpd``)
against the JAX package's: both servers run on ephemeral ports, get the
same operations, and must answer with the same status codes and the same
JSON keys — the endpoint and lifecycle cases of ``tests/test_live_ops.py``
and ``tests/test_reqledger.py::test_http_requests_and_tail_endpoints``."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import torchdistx_tpu.config as jax_config
import torchdistx_tpu_torch.config as port_config
from torchdistx_tpu import observe as jax_observe
from torchdistx_tpu.observe import flightrec as jax_flightrec
from torchdistx_tpu.observe import health as jax_health
from torchdistx_tpu.observe import httpd as jax_httpd
from torchdistx_tpu.observe import reqledger as jax_reqledger
from torchdistx_tpu.observe import slo as jax_slo
from torchdistx_tpu_torch import observe as port_observe
from torchdistx_tpu_torch.observe import flightrec as port_flightrec
from torchdistx_tpu_torch.observe import health as port_health
from torchdistx_tpu_torch.observe import httpd as port_httpd
from torchdistx_tpu_torch.observe import reqledger as port_reqledger
from torchdistx_tpu_torch.observe import slo as port_slo


def _set_base(config, **kw):
    """The handler thread sees the process-wide base config only (a
    thread-local override is not visible there), so flight_dir goes to
    the base, as TDX_FLIGHT_DIR puts it in production."""
    if hasattr(config, "set_flags"):
        config.set_flags(**kw)
    else:
        config._base = dataclasses.replace(config._base, **kw)


SIDES = {
    "jax": SimpleNamespace(observe=jax_observe, health=jax_health,
                           httpd=jax_httpd, slo=jax_slo, config=jax_config,
                           reqledger=jax_reqledger, flightrec=jax_flightrec),
    "port": SimpleNamespace(observe=port_observe, health=port_health,
                            httpd=port_httpd, slo=port_slo,
                            config=port_config, reqledger=port_reqledger,
                            flightrec=port_flightrec),
}


def _get(url: str, timeout: float = 10.0):
    """(status, body bytes): HTTP errors are answers, not raises."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _shape(status, body):
    """What must agree: the status and, for a JSON body, its keys (one
    level down for dict values)."""
    try:
        doc = json.loads(body)
    except ValueError:
        return status, None
    if not isinstance(doc, dict):
        return status, type(doc).__name__
    return status, {k: sorted(v) if isinstance(v, dict) else None
                    for k, v in doc.items()}


def _clean(side):
    side.observe.stop_background()
    side.observe.reset()
    side.health.reset()


@contextlib.contextmanager
def serving(side, tmp_path):
    """A live server on an ephemeral port, armed by the first emission."""
    _clean(side)
    side.observe.enable(True)
    port_file = tmp_path / "obs.port"
    try:
        with side.config.override(obs_port=0, obs_port_file=str(port_file)):
            side.observe.counter("tdx.test.live_ops").inc()
            server = side.httpd.get_server()
            assert server is not None and server.is_alive()
            yield server
    finally:
        side.observe.enable(None)
        _clean(side)


# -- the endpoint cases: each returns what must agree between the packages --


def case_index(side, srv, tmp):
    status, body = _get(srv.url("/"))
    return status, json.loads(body)["endpoints"]


def case_unknown_path(side, srv, tmp):
    return _get(srv.url("/nope"))[0]


def case_metrics_is_the_exporters_rendering(side, srv, tmp):
    side.observe.gauge("tdx.test.poisoned").set(float("nan"))
    side.observe.counter("tdx.test.hostile", path='a"b\\c\nd').inc()
    status, body = _get(srv.url("/metrics"))
    assert body == side.observe.counters().to_prometheus().encode()
    text = body.decode()
    return (status, "tdx_test_poisoned NaN" in text, "\nd" not in text,
            '\\"' in text)


def case_readyz_flips_with_bring_up_state(side, srv, tmp):
    out = []
    for state in ("spin_up", "warming", "serving"):
        side.health.set_state("serve", state)
        out.append(_shape(*_get(srv.url("/readyz"))))
    return out


def case_readyz_fleet_roster(side, srv, tmp):
    side.health.set_state("fleet/r0", "serving")
    side.health.set_state("fleet/r1", "draining")
    status, body = _get(srv.url("/readyz"))
    doc = json.loads(body)
    return status, sorted(doc), sorted(doc["fleet"]), doc["fleet"]["serving"]


def case_readyz_trivially_ready(side, srv, tmp):
    return _get(srv.url("/readyz"))[0]


def case_healthz_fresh_and_stale(side, srv, tmp):
    side.health.beat("elastic", period_hint_s=0.5)
    fresh = _shape(*_get(srv.url("/healthz")))
    with side.health._lock:  # age the beat past max(4 * hint, 15 s)
        t, hint = side.health._beats["elastic"]
        side.health._beats["elastic"] = (t - 1000.0, hint)
    status, body = _get(srv.url("/healthz"))
    return fresh, status, json.loads(body)["stale"]["elastic"] > 15.0


def case_slo_serves_live_windows(side, srv, tmp):
    s = side.slo.ServeSLO(name="live-ops-test")
    s.observe_ttft(0.25)
    status, body = _get(srv.url("/slo"))
    doc = json.loads(body)["slo"]["live-ops-test"]
    assert doc["ttft"]["p50"] == pytest.approx(0.25)
    return status, sorted(doc), sorted(doc["ttft"])


def case_flight_index_and_fetch(side, srv, tmp):
    fdir = str(tmp / "fl")
    _set_base(side.config, flight_dir=fdir)
    try:
        with side.config.override(flight_dir=fdir):
            with side.observe.span("pre.crash", category="t"):
                pass
            path = side.observe.flight_dump("test_reason", detail=1)
        assert path
        status, body = _get(srv.url("/flight"))
        entry = next(d for d in json.loads(body)["dumps"]
                     if d["name"] == os.path.basename(path))
        assert entry["reason"] == "test_reason"
        fetched = _get(srv.url(f"/flight/{entry['name']}"))
        assert json.loads(fetched[1]) == json.load(open(path))
        refused = [_get(srv.url(f"/flight/{name}"))[0]
                   for name in ("../flight-secret.json",
                                "..%2Fflight-secret.json", "notflight.json",
                                "flight-x.txt", "")]
        return status, sorted(entry), fetched[0], refused
    finally:
        _set_base(side.config, flight_dir=None)


def case_broken_endpoint_500_never_kills_the_server(side, srv, tmp):
    real = side.health.liveness

    def boom():
        raise RuntimeError("probe exploded")

    side.health.liveness = boom
    try:
        status, body = _get(srv.url("/healthz"))
    finally:
        side.health.liveness = real
    return (status, b"internal error: RuntimeError" in body,
            _get(srv.url("/healthz"))[0], srv.is_alive())


def case_requests_counted_by_endpoint(side, srv, tmp):
    _get(srv.url("/metrics"))
    _get(srv.url("/metrics"))
    snap = {(r["name"], tuple(sorted((r.get("labels") or {}).items()))):
            r["value"] for r in side.observe.counters().snapshot()
            if r["type"] == "counter"}
    return snap.get(("tdx.observe.http_requests",
                     (("endpoint", "metrics"),)), 0) >= 2


def case_requests_and_tail(side, srv, tmp):
    led = side.reqledger
    rid = "http-1"
    led.on_enqueue(rid, priority=0, n_prompt=4)
    led.on_admit(rid, replica="serve-r1", prefix_tokens=2)
    led.on_decode(rid, n_lanes=2, replica="serve-r1")
    led.on_finish(rid, tokens=3)
    out = [_shape(*_get(srv.url(p)))
           for p in ("/requests", f"/requests/{rid}", "/tail")]
    doc = json.loads(_get(srv.url("/requests"))[1])
    assert doc["finished"] == 1 and doc["recent"][0]["rid"] == rid
    tail = json.loads(_get(srv.url("/tail"))[1])
    assert set(tail["p99_blame"]) == set(led.STAGES)
    return out, _get(srv.url("/requests/nope"))[0]


CASES = {f.__name__[5:]: f for f in (
    case_index, case_unknown_path, case_metrics_is_the_exporters_rendering,
    case_readyz_flips_with_bring_up_state, case_readyz_fleet_roster,
    case_readyz_trivially_ready, case_healthz_fresh_and_stale,
    case_slo_serves_live_windows, case_flight_index_and_fetch,
    case_broken_endpoint_500_never_kills_the_server,
    case_requests_counted_by_endpoint, case_requests_and_tail)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_endpoint_answers_as_the_jax_daemon(case, tmp_path):
    got = {}
    for name, side in SIDES.items():
        (tmp_path / name).mkdir()
        with serving(side, tmp_path / name) as srv:
            got[name] = CASES[case](side, srv, tmp_path / name)
    assert got["port"] == got["jax"]


# -- lifecycle ------------------------------------------------------------------


def _lifecycle(side, tmp_path):
    """Port file, arm → stop → re-arm with fresh threads, disabled
    without a port; the observations that must agree."""
    out = []
    with serving(side, tmp_path) as srv:
        out.append(os.path.isfile(srv.port_file)
                   and int(open(srv.port_file).read()) == srv.port)
        side.observe.stop_background()
        out.append(os.path.exists(srv.port_file))
    side.observe.enable(True)
    try:
        with side.config.override(
                obs_port=0, obs_port_file=str(tmp_path / "p1"),
                metrics_export_s=0.05,
                metrics_path=str(tmp_path / "m.prom")):
            side.observe.counter("tdx.test.cycle").inc()
            first = side.httpd.get_server()
            exporter = side.slo._exporter
            side.observe.counter("tdx.test.cycle").inc()
            out.append(side.httpd.get_server() is first)
            side.observe.stop_background()
            out += [side.httpd.get_server(), first.is_alive(),
                    exporter.is_alive(), side.observe._autoflush_armed]
            side.observe.counter("tdx.test.cycle").inc()
            second = side.httpd.get_server()
            out += [second is not first, second.is_alive(),
                    _get(second.url("/healthz"))[0]]
        _clean(side)
        out.append(side.httpd.ensure_httpd())  # no port configured
        side.observe.counter("tdx.test.no_port").inc()
        out.append(side.httpd.get_server())
    finally:
        side.observe.enable(None)
        _clean(side)
    names = {t.name for t in threading.enumerate()}
    out += ["tdx-obs-httpd" in names, "tdx-metrics-exporter" in names]
    return out


def test_lifecycle_as_the_jax_daemon(tmp_path):
    got = {}
    for name, side in SIDES.items():
        (tmp_path / name).mkdir()
        got[name] = _lifecycle(side, tmp_path / name)
    assert got["port"] == got["jax"]
    assert got["port"] == [True, False, True, None, False, False, False,
                           True, True, 200, None, None, False, False]
