"""Per-process live status endpoint: /metrics, /healthz, /status over
HTTP, and a serving replica's /generate and /drain.

Port of ``paddle_tpu/status.py``: stdlib-only (http.server on a daemon
thread), with zero extra dependencies. The endpoints:

  /metrics   Prometheus text exposition (monitor.to_prometheus()) — the
             scrape target; includes the goodput_* series
  /healthz   tiny liveness JSON (rank, pid, step-progress count); when
             this process registered a serving engine
             (serving.set_replica_engine) it also carries the engine's
             `serving` sub-document (draining/active/queued) — the
             router's health + least-loaded input
  /generate  POST (serving replicas only): dispatch one generation
             request into the registered engine — {request_id, prompt,
             max_new_tokens, deadline_s} -> {tokens, cached, rank}.
             503 when no engine is registered or the replica is
             draining; failures return the TYPED error name, never a
             hang (serving/router.py is the intended client)
  /drain     POST: begin connection draining — the engine finishes
             admitted work, rejects new submissions, and /healthz
             reports drained once idle
  /status    the operator view (goodput.status()): current step,
             throughput EMA, goodput %, bucket breakdown, the
             flight-recorder tail of recent spans, and a `serving`
             section (serving.ledger.status(): SLO table — tokens/s,
             TTFT/latency p50/p99 — batch occupancy, KV utilization,
             serving goodput buckets, span and roofline
             reconciliations; {available: false} until an engine runs),
             a `memory` section (memwatch.status(): live bytes,
             lifetime peak, per-step watermark tail, leak events) and a
             `dynamics` section (dynamics.status(): loss/grad EMA,
             anomaly counts, trajectory tail)

The JAX package's /status also carries a `comms` section (commswatch),
which is not ported yet, so here it reads
``{"available": false, "not_ported": "<ROADMAP item>"}`` (:data:`NOT_PORTED`)
rather than raising: a 500 would hide the other sections.

Enable with PADDLE_TPU_STATUS_PORT=<port> (declared in flags.py; 0 =
off), or call :func:`start_status_server`. Serving must never interfere
with the work it reports on: handlers catch their own failures and a
busy port degrades to a warning, not a crash.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import dynamics as _dynamics
from . import flags as _flags
from . import goodput as _goodput
from . import memwatch as _memwatch
from . import monitor as _monitor
from .serving import ledger as _serving_ledger

__all__ = ["start_status_server", "stop_status_server", "server_port",
           "free_port", "NOT_PORTED"]

# the JAX package's /status sections whose modules are not ported yet,
# each with the ROADMAP item that brings it
NOT_PORTED = {"comms": "A12"}

_ENDPOINTS = ("/status", "/metrics", "/healthz", "/generate", "/drain")

_SERVER: Optional[ThreadingHTTPServer] = None
_THREAD: Optional[threading.Thread] = None


class _StatusHandler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-status/1"

    def log_message(self, fmt, *args):  # no per-request stderr spam
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, doc) -> None:
        self._send(code, json.dumps(doc, indent=1), "application/json")

    def do_GET(self):  # noqa: N802 (http.server contract)
        path = self.path.split("?", 1)[0].rstrip("/") or "/status"
        try:
            if path == "/metrics":
                self._send(200, _monitor.to_prometheus(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                doc = {
                    "status": "ok",
                    "rank": _monitor.trainer_rank(),
                    "pid": os.getpid(),
                    "progress": _monitor.progress_count(),
                    "time_unix": time.time(),
                }
                engine = _replica_engine()
                if engine is not None:
                    doc["serving"] = engine.healthz_info()
                self._send_json(200, doc)
            elif path == "/status":
                doc = _goodput.status()
                doc["memory"] = _memwatch.status()
                doc["dynamics"] = _dynamics.status()
                for section, item in NOT_PORTED.items():
                    doc[section] = {"available": False, "not_ported": item}
                doc["serving"] = _serving_ledger.status()
                self._send_json(200, doc)
            else:
                self._send_json(404, {"error": f"unknown path {path!r}",
                                      "endpoints": list(_ENDPOINTS)})
        except Exception as e:  # serving must never take down training
            try:
                self._send_json(500, {"error": repr(e)})
            except OSError:
                pass

    def do_POST(self):  # noqa: N802 (http.server contract)
        path = self.path.split("?", 1)[0].rstrip("/")
        try:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            body = json.loads(raw.decode() or "{}") if raw else {}
        except (ValueError, OSError) as e:
            self._send_json(400, {"error": f"bad request body: {e!r}"})
            return
        try:
            if path == "/generate":
                self._handle_generate(body)
            elif path == "/drain":
                self._handle_drain()
            else:
                self._send_json(404, {"error": f"unknown path {path!r}",
                                      "endpoints": list(_ENDPOINTS)})
        except Exception as e:
            try:
                self._send_json(500, {"error": repr(e)})
            except OSError:
                pass

    def _handle_generate(self, body: dict) -> None:
        """The replica-side dispatch endpoint: one generation request
        into the registered engine. Failures are TYPED json (the error
        class name the router surfaces), bounded (the wait cannot outlive
        the request's deadline by more than a grace beat) — a dead or
        draining replica answers loudly, it never hangs the caller."""
        from .framework import errors as _errors

        engine = _replica_engine()
        if engine is None:
            self._send_json(503, {"error": "no serving engine registered "
                                  "on this rank"})
            return
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            self._send_json(400, {"error": "prompt must be a non-empty "
                                  "token list"})
            return
        rid = body.get("request_id") or None
        deadline_s = float(body.get("deadline_s")
                           or engine.default_slo_s)
        try:
            handle = engine.submit(
                prompt, max_new_tokens=int(body.get("max_new_tokens", 16)),
                deadline_s=deadline_s, request_id=rid,
                trace=body.get("__trace__") or None)
            # +1s past the deadline, strictly INSIDE the router client's
            # socket timeout (+2s): the typed 504 must reach the caller
            # before its transport gives up, and an abandoned request
            # must not pin this handler thread
            tokens = handle.result(timeout=deadline_s + 1.0)
        except _errors.errors.Unavailable as e:
            self._send_json(503, {
                "error": str(e)[:500], "error_type": type(e).__name__,
                "draining": engine.draining})
            return
        except _errors.errors.ExecutionTimeout as e:
            self._send_json(504, {"error": str(e)[:500],
                                  "error_type": type(e).__name__})
            return
        except Exception as e:
            self._send_json(500, {"error": str(e)[:500],
                                  "error_type": type(e).__name__})
            return
        self._send_json(200, {
            "request_id": handle.request_id,
            "tokens": [int(t) for t in tokens],
            "cached": bool(handle.cached),
            "rank": _monitor.trainer_rank(),
            "pid": os.getpid(),
            # the engine-side latency decomposition rides the reply so
            # the router can assemble the FULL-STACK attribution record
            # (its buckets + transport + these) without a second RPC
            "attribution": handle.attribution,
            "engine_e2e_s": handle.engine_e2e_s,
        })

    def _handle_drain(self) -> None:
        engine = _replica_engine()
        if engine is None:
            self._send_json(503, {"error": "no serving engine registered "
                                  "on this rank"})
            return
        engine.drain()
        self._send_json(200, {"draining": True,
                              "drained": engine.drained(),
                              **engine.healthz_info()})


def _replica_engine():
    from . import serving as _serving

    return _serving.replica_engine()


def start_status_server(port: Optional[int] = None,
                        host: Optional[str] = None) -> ThreadingHTTPServer:
    """Start (or return the already-running) status server. `port` 0
    binds an ephemeral port — read it back via `server_port()`.
    Loopback-only by default: the endpoints are unauthenticated, so
    exposing them beyond the host (a Prometheus scraper on another
    node) is an explicit opt-in — `host="0.0.0.0"` here, or
    PADDLE_TPU_STATUS_HOST=0.0.0.0 for the env-wired path."""
    global _SERVER, _THREAD
    if _SERVER is not None:
        return _SERVER
    if port is None:
        port = int(_flags.env_flag("PADDLE_TPU_STATUS_PORT"))
    if host is None:
        host = str(_flags.env_flag("PADDLE_TPU_STATUS_HOST"))
    srv = ThreadingHTTPServer((host, int(port)), _StatusHandler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever,
                         name="paddle-tpu-status", daemon=True)
    t.start()
    _SERVER, _THREAD = srv, t
    return srv


def stop_status_server() -> None:
    global _SERVER, _THREAD
    if _SERVER is not None:
        _SERVER.shutdown()
        _SERVER.server_close()
    _SERVER = _THREAD = None


def server_port() -> Optional[int]:
    return _SERVER.server_port if _SERVER is not None else None


def free_port() -> int:
    """An ephemeral loopback port (bind-0 probe) — the shared helper
    multi-process runs use to place status endpoints (a replica's
    PADDLE_TPU_STATUS_PORT)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# env-driven wiring: a supervisor exports PADDLE_TPU_STATUS_PORT per
# spawned replica; standalone runs export it by hand. A taken port must
# degrade to a warning — the job matters more than its dashboard.
_env_port = int(_flags.env_flag("PADDLE_TPU_STATUS_PORT"))
if _env_port > 0:
    try:
        start_status_server(_env_port)
    except OSError as e:
        print(f"[paddle_tpu_torch.status] could not bind status port "
              f"{_env_port}: {e}", file=sys.stderr)
