"""The HTTP front the model server and the serving front door share: a
minimal app on the standard library (``http.server``), with JSON
helpers and the success/failure envelopes of the /v1/generate contract.

``models/serve.py`` serves a replica through it and re-exports every
name here; ``platform/activator.py`` serves the front door through it.
It imports no torch, so the controllers process that hosts the
activator starts without it.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from kubeflow_tpu_torch.telemetry import causal

__all__ = ["App", "HttpError", "Request", "Response", "failure",
           "json_response", "success"]

log = logging.getLogger("kubeflow_tpu_torch.serve")


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


@dataclasses.dataclass
class Request:
    args: Dict[str, str]
    headers: object  # email.message.Message: case-insensitive .get
    body: bytes
    method: str = "GET"

    def get_json(self):
        """The body as JSON, or None when it is not valid JSON."""
        try:
            return json.loads(self.body or b"null")
        except ValueError:
            return None


Response = Tuple[int, Dict[str, str], bytes]


def json_response(data, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    return status, h, json.dumps(data).encode()


def success(data: Optional[dict] = None, status: int = 200) -> Response:
    body = {"success": True, "status": status}
    body.update(data or {})
    return json_response(body, status)


def failure(message: str, status: int = 400,
            headers: Optional[Dict[str, str]] = None) -> Response:
    return json_response({"success": False, "status": status, "log": message,
                          "user_action": message}, status, headers)


class App:
    """Routes (method, path) to handlers ``fn(request) -> Response``, and
    a path under a prefix with no route of its own to ``fn(request,
    rest)`` (``route_prefix``); a handler runs with the request's
    ``traceparent`` header, when it has a valid one, as its thread's
    current causal context."""

    def __init__(self, name: str):
        self.name = name
        self.routes: Dict[str, Dict[str, Callable]] = {}
        self.prefix_routes: Dict[str, Dict[str, Callable]] = {}

    def route(self, path: str, methods=("GET",)):
        def deco(fn):
            for m in methods:
                self.routes.setdefault(path, {})[m] = fn
            return fn
        return deco

    def route_prefix(self, prefix: str, methods=("GET",)):
        def deco(fn):
            for m in methods:
                self.prefix_routes.setdefault(prefix, {})[m] = fn
            return fn
        return deco

    def handle(self, method: str, target: str, headers,
               body: bytes) -> Response:
        url = urlsplit(target)
        args = {k: v[-1] for k, v in parse_qs(url.query).items()}
        handlers, extra = self.routes.get(url.path), ()
        if handlers is None:
            for prefix, by_method in self.prefix_routes.items():
                if url.path.startswith(prefix):
                    handlers, extra = by_method, (url.path[len(prefix):],)
                    break
        if handlers is None:
            return failure(f"no route {url.path}", 404)
        fn = handlers.get(method)
        if fn is None:
            return failure(f"method {method} not allowed", 405)
        ctx = causal.parse_traceparent(
            headers.get(causal.TRACEPARENT_HEADER) if headers else None)
        try:
            with causal.use(ctx):
                return fn(Request(args, headers, body, method), *extra)
        except HttpError as e:
            return failure(e.message, e.status)
        except Exception as e:  # noqa: BLE001 — the server must keep serving
            log.exception("%s %s failed", method, url.path)
            return failure(f"{type(e).__name__}: {e}", 500)

    def make_server(self, host: str = "127.0.0.1",
                    port: int = 0) -> ThreadingHTTPServer:
        """A threaded HTTP server for this app (port 0: any free port,
        read it back from ``server.server_address``)."""
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _dispatch(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                status, headers, payload = app.handle(
                    self.command, self.path, self.headers, body)
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = _dispatch

            def log_message(self, fmt, *args):
                log.debug("%s " + fmt, self.address_string(), *args)

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        return server
