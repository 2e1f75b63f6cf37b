"""Live telemetry HTTP endpoints: /metrics, /healthz, /readyz, /slo, /flight
(the port's own copy of ``torchdistx_tpu/observe/httpd.py``).

The daemon makes the observe layer's state scrapeable LIVE from the
running process, with the same rendering code as the files an operator
gathers after the fact (no second source of truth):

``/metrics``
    The counter registry as Prometheus text — literally
    ``counters().to_prometheus()``, the same path the file exporter
    uses, including its NaN/label-escaping behavior.
``/healthz``
    Liveness (:mod:`.health`): 200 unless a registered heartbeat (the
    elastic step loop) went stale; body is the state/heartbeat snapshot
    as JSON.
``/readyz``
    Readiness: 200 only when every registered bring-up component is in
    a ready state — a serve replica flips true only after its program
    set is compiled/fetched (``spin_up`` → ``warming`` → ``serving``).
    ``fleet/<r>`` components aggregate instead of gating individually:
    the probe is 200 iff at least one fleet replica is serving, and the
    body's ``fleet`` key carries the per-replica state roster plus the
    live ``serving`` count (one dead replica of N never fails the pod).
``/slo``
    Every live :class:`~.slo.ServeSLO`'s sliding-window percentiles as
    JSON (:func:`.slo.snapshot_all`).
``/flight``
    Flight-recorder dumps: the index lists ``TDX_FLIGHT_DIR``'s bundles
    (name/reason/time/size), ``/flight/<name>`` fetches one verbatim —
    reading a post-mortem during the incident instead of after it.
``/requests``
    The per-request attribution ledger (:mod:`.reqledger`): live
    in-flight summaries plus the recent-completions ring with full
    event timelines; ``/requests/<rid>`` fetches one request's detail.
``/tail``
    Fleet-wide tail attribution over the finished-request window:
    per-stage latency percentiles, mean stage shares, and the "p99
    blame" breakdown (where the slowest 5% actually spent their time).

Lifecycle mirrors the periodic exporter (:mod:`.slo`): opt-in via
``TDX_OBS_PORT`` (port 0 = ephemeral, the bound port is written to
``TDX_OBS_PORT_FILE``), armed lazily on the first telemetry emission
(:func:`ensure_httpd` from ``observe._arm_autoflush``), daemon threads
throughout, and :func:`stop_httpd` (wired into
``observe.stop_background`` / atexit) shuts the listener down cleanly so
pytest never leaks a thread.  Handlers are exception-proof — a broken
endpoint returns 500, it never kills the serving thread or the process.

Security: binds ``127.0.0.1`` unless ``TDX_OBS_BIND`` widens it
deliberately; the surface is read-only telemetry, but flight dumps carry
config/env fingerprints — treat a widened bind like any other
introspection port.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

__all__ = ["ObsServer", "ensure_httpd", "stop_httpd"]


def _default_port_file() -> str:
    return os.path.join(tempfile.gettempdir(), f"tdx-obs-{os.getpid()}.port")


class _Handler(BaseHTTPRequestHandler):
    server_version = "tdx-obs"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass  # telemetry must not spam the run's stderr

    def do_GET(self) -> None:  # noqa: N802 — stdlib dispatch name
        try:
            status, ctype, body = self._route(self.path.split("?", 1)[0])
        except Exception as e:  # noqa: BLE001 — exception-proof contract
            status, ctype = 500, "text/plain; charset=utf-8"
            body = f"internal error: {type(e).__name__}: {e}\n".encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # a vanished scraper is not our problem

    # -- routing ---------------------------------------------------------

    def _route(self, path: str) -> Tuple[int, str, bytes]:
        from . import counter, enabled

        if enabled():
            counter("tdx.observe.http_requests",
                    endpoint=path.split("/", 2)[1] or "index").inc()
        if path in ("/", "/index"):
            return self._json(200, {"endpoints": [
                "/metrics", "/healthz", "/readyz", "/slo", "/flight",
                "/requests", "/tail",
            ]})
        if path == "/metrics":
            from . import counters

            text = counters().to_prometheus()
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    text.encode())
        if path == "/healthz":
            from . import health

            alive, detail = health.liveness()
            return self._json(200 if alive else 503, detail)
        if path == "/readyz":
            from . import health

            ready, detail = health.readiness()
            return self._json(200 if ready else 503, detail)
        if path == "/slo":
            from . import slo

            return self._json(200, {"slo": slo.snapshot_all()})
        if path == "/requests":
            from . import reqledger

            return self._json(200, reqledger.requests_report())
        if path.startswith("/requests/"):
            from . import reqledger

            detail = reqledger.summary(path[len("/requests/"):])
            if detail is None:
                return (404, "text/plain; charset=utf-8", b"not found\n")
            return self._json(200, detail)
        if path == "/tail":
            from . import reqledger

            return self._json(200, reqledger.tail_report())
        if path == "/flight":
            return self._json(200, {"dumps": _flight_index()})
        if path.startswith("/flight/"):
            return _flight_fetch(path[len("/flight/"):])
        return (404, "text/plain; charset=utf-8", b"not found\n")

    @staticmethod
    def _json(status: int, doc) -> Tuple[int, str, bytes]:
        body = json.dumps(doc, default=str).encode() + b"\n"
        return status, "application/json; charset=utf-8", body


def _flight_dir() -> Optional[str]:
    from .. import config

    return config.expand_path(config.get().flight_dir)


def _flight_index() -> list:
    fdir = _flight_dir()
    if not fdir or not os.path.isdir(fdir):
        return []
    out = []
    for name in sorted(os.listdir(fdir)):
        if not (name.startswith("flight-") and name.endswith(".json")):
            continue
        path = os.path.join(fdir, name)
        entry = {"name": name}
        try:
            entry["bytes"] = os.path.getsize(path)
            with open(path) as f:
                doc = json.load(f)
            entry.update({
                k: doc[k] for k in ("reason", "time", "pid", "schema",
                                    "trace_id")
                if k in doc
            })
        except (OSError, ValueError):
            entry["unreadable"] = True
        out.append(entry)
    return out


def _flight_fetch(name: str) -> Tuple[int, str, bytes]:
    # basename-only, fixed prefix/suffix: the endpoint serves flight
    # bundles, not the filesystem.
    if (os.path.basename(name) != name
            or not name.startswith("flight-") or not name.endswith(".json")):
        return (404, "text/plain; charset=utf-8", b"not found\n")
    fdir = _flight_dir()
    path = os.path.join(fdir, name) if fdir else None
    if not path or not os.path.isfile(path):
        return (404, "text/plain; charset=utf-8", b"not found\n")
    with open(path, "rb") as f:
        return (200, "application/json; charset=utf-8", f.read())


class ObsServer:
    """One live-telemetry listener: a ThreadingHTTPServer on a daemon
    thread, plus the port-file bookkeeping for ephemeral binds."""

    def __init__(self, bind: str, port: int,
                 port_file: Optional[str] = None):
        self._httpd = ThreadingHTTPServer((bind, port), _Handler)
        self._httpd.daemon_threads = True
        self.bind = bind
        self.port = int(self._httpd.server_address[1])
        self.port_file = port_file
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="tdx-obs-httpd",
        )
        self._thread.start()
        if port_file:
            # Atomic: a launcher polling for the port must never read a
            # half-written file.
            parent = os.path.dirname(os.path.abspath(port_file))
            os.makedirs(parent, exist_ok=True)
            tmp = f"{port_file}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(str(self.port))
            os.replace(tmp, port_file)

    def url(self, path: str = "") -> str:
        host = "127.0.0.1" if self.bind in ("", "0.0.0.0") else self.bind
        return f"http://{host}:{self.port}{path}"

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self) -> None:
        """Shut the listener down and join its thread — no dangling
        non-daemon joins, no port-file litter."""
        try:
            self._httpd.shutdown()
        finally:
            self._httpd.server_close()
        self._thread.join(timeout=5.0)
        if self.port_file:
            try:
                os.remove(self.port_file)
            except OSError:
                pass


_lock = threading.Lock()
_server: Optional[ObsServer] = None


def ensure_httpd() -> Optional[ObsServer]:
    """Start the daemon if ``obs_port`` is configured and none is
    running (idempotent — safe from every emission path); returns the
    server (None when disabled or the bind failed)."""
    from .. import config

    cfg = config.get()
    if cfg.obs_port is None:
        return None
    global _server
    with _lock:
        if _server is not None and _server.is_alive():
            return _server
        port_file = config.expand_path(cfg.obs_port_file)
        if cfg.obs_port == 0 and not port_file:
            port_file = _default_port_file()
        try:
            _server = ObsServer(cfg.obs_bind, cfg.obs_port, port_file)
        except OSError:
            # A taken port / forbidden bind must not kill the run the
            # telemetry serves; the operator sees the missing endpoint.
            _server = None
        return _server


def get_server() -> Optional[ObsServer]:
    return _server


def stop_httpd() -> None:
    """Stop the running daemon and join its thread (tests, orderly
    shutdown); idempotent."""
    global _server
    with _lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()
