"""HTTP/JSON transport for the mapping service (stdlib-only).

``MappingHTTPServer`` puts ``MappingService`` behind a
``ThreadingHTTPServer`` speaking the exact wire forms the service
already defines — ``MappingRequest.from_dict`` in,
``MappingResponse.to_json`` out — so the in-process client
(``run.py serve-dse``), the HTTP client (``run.py serve-http`` + curl)
and the tests all exercise one schema. No third-party web framework:
the repo's no-new-dependencies rule holds, and ``http.server`` is
plenty for a request/response service whose unit of work is a mapping
sweep, not a byte shuffle.

Routes (DESIGN.md Section 13):

* ``POST /v1/mapping`` — body is a ``MappingRequest`` dict; answers
  200 with the ``MappingResponse`` JSON. Malformed JSON or an invalid
  request field is a 400 with ``{"error": ...}``; admission-control
  shed is a 429 with a ``Retry-After`` hint; an internal failure is a
  500 carrying the exception text.
* ``GET /v1/metrics`` — the service registry in Prometheus text
  exposition format (``repro_torch.obs.render_prometheus``).
* ``GET /v1/healthz`` — liveness: ``{"status": "ok"}`` plus queue
  depth, always 200 while the process serves.
* ``GET /v1/debug/requests`` — the flight recorder's recent ring,
  newest first (``?limit=N`` caps the list, ``?slow=1`` reads the
  full-detail slow ring); 404 when the recorder is disabled
  (``flight_cap=0``).
* ``GET /v1/debug/requests/<key>`` — the fullest record held for one
  request key (prefix match, so the first 8–12 hex chars of a
  ``request_key`` suffice); 404 when unknown.

Determinism over the wire: responses are rendered with
``to_json(indent=None, sort_keys)`` — the same canonical serialization
the in-process path produces — so a repeated request's body (memo
replay included) is byte-identical except for its provenance fields,
and ``frontier_json`` is byte-identical, full stop.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..obs import render_prometheus
from .jobs import QueueFull, QueueShutdown
from .service import MappingRequest, MappingService

#: Retry-After hint (seconds) sent with 429 shed responses
RETRY_AFTER_S = 1

#: request bodies past this are refused outright (a MappingRequest is
#: a few hundred bytes; anything bigger is a client bug or abuse)
MAX_BODY_BYTES = 1 << 20


class _Handler(BaseHTTPRequestHandler):
    """One HTTP exchange; the service lives on ``self.server``."""

    # ThreadingHTTPServer default (HTTP/1.0) closes per request; 1.1
    # keeps benchmark client connections alive across the storm
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        """Silence per-request stderr lines (telemetry supersedes)."""

    def _send(self, code: int, body: bytes,
              content_type: str = "application/json",
              retry_after: Optional[int] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj,
                   retry_after: Optional[int] = None) -> None:
        self._send(code, (json.dumps(obj, sort_keys=True) + "\n").encode(),
                   retry_after=retry_after)

    def do_GET(self):  # noqa: N802 - stdlib handler name
        """Route GETs: metrics, healthz, debug/requests, else 404."""
        svc = self.server.service
        parts = urlsplit(self.path)
        path = parts.path
        if path == "/v1/metrics":
            self._send(200,
                       render_prometheus(svc.metrics_snapshot()).encode(),
                       content_type="text/plain; version=0.0.4")
        elif path == "/v1/healthz":
            self._send_json(200, {
                "status": "ok",
                "inflight": svc._queue.inflight(),
                "pending": svc._queue.pending()})
        elif path == "/v1/debug/requests":
            if not svc.flight.enabled:
                self._send_json(404, {"error": "flight recorder disabled "
                                               "(flight_cap=0)"})
                return
            q = parse_qs(parts.query)
            try:
                limit = int(q["limit"][0]) if "limit" in q else None
            except ValueError:
                self._send_json(400, {"error": "limit must be an int"})
                return
            slow_only = q.get("slow", ["0"])[0] not in ("0", "", "false")
            recs = svc.flight.snapshot(limit=limit, slow_only=slow_only)
            self._send_json(200, {"requests": recs, "count": len(recs)})
        elif path.startswith("/v1/debug/requests/"):
            if not svc.flight.enabled:
                self._send_json(404, {"error": "flight recorder disabled "
                                               "(flight_cap=0)"})
                return
            key = path[len("/v1/debug/requests/"):]
            rec = svc.flight.get(key)
            if rec is None:
                self._send_json(404,
                                {"error": f"no flight record for {key!r}"})
            else:
                self._send_json(200, rec)
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib handler name
        """Route POSTs: /v1/mapping, else 404."""
        if self.path != "/v1/mapping":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            n = -1
        if n < 0 or n > MAX_BODY_BYTES:
            self._send_json(400, {"error": "bad Content-Length"})
            return
        try:
            req = MappingRequest.from_dict(json.loads(self.rfile.read(n)))
        except (ValueError, TypeError) as e:
            # covers malformed JSON, unknown fields, and every
            # validation error MappingRequest raises itself
            self._send_json(400, {"error": str(e)})
            return
        try:
            resp = self.server.service.request(req)
        except QueueFull as e:
            self._send_json(429, {"error": f"shed: {e}"},
                            retry_after=RETRY_AFTER_S)
            return
        except QueueShutdown as e:
            self._send_json(503, {"error": str(e)})
            return
        except Exception as e:   # a sweep failure is the server's bug
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, (resp.to_json() + "\n").encode())


class MappingHTTPServer:
    """A ``MappingService`` bound to a listening HTTP socket.

    Owns the ``ThreadingHTTPServer`` and its accept loop thread;
    ``port=0`` binds an ephemeral port (tests, parallel CI) readable
    back from ``.port`` once constructed. The caller owns the service's
    lifecycle: ``close()`` stops accepting, then drains the service.

    Usage::

        svc = MappingService(journal_path=..., max_pending=32)
        server = MappingHTTPServer(svc, host="127.0.0.1", port=8099)
        server.start()          # returns immediately
        ...
        server.close()          # stop accepting, drain sweeps
    """

    def __init__(self, service: MappingService,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        # hand the service to handlers through the server object —
        # BaseHTTPRequestHandler instances are constructed per request
        self._httpd.service = service
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        """Bound host of the listening socket."""
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        """Bound port (the OS's pick when constructed with port=0)."""
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        """Base URL of the server, e.g. ``http://127.0.0.1:8099``."""
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MappingHTTPServer":
        """Start the accept loop on a daemon thread; returns self."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="mapping-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Run the accept loop on the calling thread (the CLI path)."""
        self._httpd.serve_forever(poll_interval=0.1)

    def close(self) -> None:
        """Stop accepting connections, join the accept thread, close
        the socket, and drain the service's in-flight sweeps."""
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._httpd.server_close()
        self.service.close()
