"""Minimal serving endpoint for the deployment tier.

PyTorch counterpart of ``spintorque_tpu/deployment/server.py``: a
dependency-free HTTP endpoint exposing the package's live health,
readiness and metrics, for container HEALTHCHECKs, load-balancer probes
(``compliance.GlobalDeploymentManager`` health) and Prometheus scrapes.

Endpoints:
  GET /healthz    - serving_health() snapshot (200 when HEALTHY, else 503)
  GET /readiness  - production_readiness() report (200 when ready)
  GET /metrics    - text exposition of throughput/device gauges
  GET /info       - backend, device and process topology

The health checks run on ``device`` (the card unless the caller asks for
"cpu"). ``start`` runs them once, then a background refresh thread runs
them every ``refresh_interval`` seconds, so probe requests answer from the
latest snapshot instead of running device work inside the request. With
device checks on, a refresh integrates a pulse and steps an env: on the
card it launches the pulse kernel from the refresh thread, on the card
that the process it monitors uses.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

# The longest ``stop`` waits for a refresh in flight.
_REFRESH_JOIN_S = 120.0


class HealthState:
    """Latest health/readiness snapshot, refreshed off the request path."""

    def __init__(self, refresh_interval: float = 60.0,
                 run_device_checks: bool = True, device=None):
        from ..parallel.mesh import resolve_device

        self.refresh_interval = refresh_interval
        self.run_device_checks = run_device_checks
        self.device = resolve_device(device, None)
        self._lock = threading.Lock()
        self._health: Optional[Dict[str, Any]] = None
        self._readiness: Optional[Dict[str, Any]] = None
        self._metrics: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def refresh(self) -> None:
        from .compliance import production_readiness
        from .manager import serving_health

        try:
            health = serving_health(self.device)
        except Exception as e:  # pragma: no cover - defensive
            health = {"status": "ERROR", "error": str(e)}
        try:
            readiness = production_readiness(
                run_device_checks=self.run_device_checks, device=self.device
            )
        except Exception as e:  # pragma: no cover
            readiness = {"production_ready": False, "error": str(e)}
        with self._lock:
            self._health = health
            self._readiness = readiness
            self._metrics["spintorque_health_ok"] = float(
                health.get("status") == "HEALTHY"
            )
            self._metrics["spintorque_ready"] = float(
                readiness.get("production_ready", False)
            )
            self._metrics["spintorque_devices"] = float(
                health.get("devices", 0)
            )
            self._metrics["spintorque_last_refresh_unixtime"] = time.time()

    def record_metric(self, name: str, value: float) -> None:
        """Export an application gauge (e.g. env_steps_per_s) on /metrics."""
        with self._lock:
            self._metrics[name] = float(value)

    def metric(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._metrics.get(name, default)

    def start(self) -> None:
        if self._thread is not None:
            return
        self.refresh()

        def loop():
            while not self._stop.wait(self.refresh_interval):
                self.refresh()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="spintorque-health-refresh")
        self._thread.start()

    def stop(self) -> None:
        """Stop refreshing; waits for a refresh in flight, so no device
        work of this state outlives the call."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=_REFRESH_JOIN_S)

    @property
    def health(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._health or {"status": "UNKNOWN"})

    @property
    def readiness(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._readiness or {"production_ready": False})

    def metrics_text(self) -> str:
        with self._lock:
            items = sorted(self._metrics.items())
        lines = []
        for name, value in items:
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {value:.10g}")
        return "\n".join(lines) + "\n"


def _info(state: HealthState) -> Dict[str, Any]:
    import torch

    from ..parallel import process_info

    info = process_info()
    dev = state.device
    return {
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "local_devices": info["local_device_count"],
        "process_index": info["process_index"],
        "process_count": info["process_count"],
        "distributed_backend": info["backend"],
    }


def _make_handler(state: HealthState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; logs go through logging
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: Dict[str, Any]) -> None:
            self._send(code, json.dumps(obj, default=str).encode(),
                       "application/json")

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                h = state.health
                self._send_json(200 if h.get("status") == "HEALTHY" else 503, h)
            elif self.path == "/readiness":
                r = state.readiness
                self._send_json(200 if r.get("production_ready") else 503, r)
            elif self.path == "/metrics":
                self._send(200, state.metrics_text().encode(),
                           "text/plain; version=0.0.4")
            elif self.path == "/info":
                self._send_json(200, _info(state))
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

    return Handler


class ServingEndpoint:
    """Threaded HTTP endpoint wrapping a HealthState on ``device``."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080,
                 refresh_interval: float = 60.0,
                 run_device_checks: bool = True, device=None):
        self.state = HealthState(refresh_interval, run_device_checks, device)
        self._server = ThreadingHTTPServer((host, port),
                                           _make_handler(self.state))
        self.port = self._server.server_address[1]  # resolved when port=0
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.state.start()
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="spintorque-serve")
        self._thread.start()

    def stop(self) -> None:
        self.state.stop()
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join()

    def serve_forever(self) -> None:
        """Blocking variant for the CLI `serve` subcommand."""
        self.state.start()
        try:
            self._server.serve_forever()
        finally:
            self.state.stop()
            self._server.server_close()


__all__ = ["HealthState", "ServingEndpoint"]
