"""The admission webhook's HTTPS server.  The port's copy of
``kubeflow_tpu/platform/webhook/server.py`` on the standard library's
``http.server`` and ``ssl``, where the reference's runs on werkzeug.

``WebhookApp`` serves ``POST /apply-poddefault`` (the PodDefault merge of
``mutate.py``, answered as an AdmissionReview with a JSON patch),
``POST /convert`` (the Notebook CRD's ConversionReview,
``apis/notebook.convert_review``) and ``GET /healthz``.  A PodDefault
that breaks the merge fails OPEN: the pod is admitted unpatched with the
reason in ``status.message``, since a 500 under ``failurePolicy=Fail``
would block every pod of the namespace.  A conversion that raises is
answered as a ``Failed`` ConversionReview, never a bare 500.

``WebhookServer`` speaks HTTP/1.1 keep-alive with Nagle off (the API
server keeps its webhook connections; a fresh handshake a pod, or a TLS
record queued behind a delayed ACK, shows in spawn-to-ready).  The
listening socket stays plain: each accepted connection does its TLS
handshake in its own thread, so one client that stalls its handshake
holds its own thread and not the accept loop that every admission
waits on.  Certificates rotate the cert-manager way: a new pair on disk
is trial-loaded on a scratch context, then loaded into the live one
(``reload_certs``, polled every ``CERT_RELOAD_SECONDS``); a pair that
does not load (a writer caught between its renames, a torn file) is
counted in ``reload_failures`` and retried on the next poll, and the
server keeps handshaking with the previous pair.  ``stop`` returns at
once on a server that was never started.

Drive it on the CPU::

    cert, key = write_pair(d, *generate_self_signed())
    srv = WebhookServer(kube, host="127.0.0.1", port=0,
                        cert_file=cert, key_file=key)
    srv.start()        # https://127.0.0.1:<srv.port>/apply-poddefault
    srv.stop()
"""
from __future__ import annotations

import http.server
import json
import logging
import os
import socket
import socketserver
import ssl
import threading
from typing import Dict, Optional, Tuple
from urllib.parse import urlsplit

from kubeflow_tpu_torch.platform.k8s.types import PODDEFAULT
from kubeflow_tpu_torch.platform.webhook.mutate import mutate_admission_review

log = logging.getLogger("kubeflow_tpu_torch.webhook")

Response = Tuple[int, Dict[str, str], bytes]


def _text(body: str, status: int = 200) -> Response:
    return status, {"Content-Type": "text/plain; charset=utf-8"}, body.encode()


def _json(doc) -> Response:
    return 200, {"Content-Type": "application/json"}, json.dumps(doc).encode()


class WebhookApp:
    """The webhook's routes over ``client`` (its PodDefaults are listed
    from it at each admission)."""

    def __init__(self, client):
        self.client = client
        # Load or build the native engine now: the admission path must
        # never absorb its one-time build (an API server's webhook
        # timeout is 10-30 s).
        from kubeflow_tpu_torch.platform import native

        native.preload()

    def handle(self, method: str, target: str, headers,
               body: bytes) -> Response:
        """One request: ``(status, headers, body)``."""
        path = urlsplit(target).path
        if path == "/healthz":
            return _text("ok")
        if path == "/apply-poddefault" and method == "POST":
            return self.apply_poddefault(
                (headers.get("Content-Type") or "") if headers else "", body)
        if path == "/convert" and method == "POST":
            return self.convert(body)
        return _text("not found", 404)

    def convert(self, body: bytes) -> Response:
        """The CRD conversion webhook of the multi-version Notebook CRD."""
        from kubeflow_tpu_torch.platform.apis import notebook as nbapi

        try:
            review = json.loads(body.decode("utf-8", "replace"))
        except json.JSONDecodeError:
            return _text("bad json", 400)
        try:
            out = nbapi.convert_review(review)
        except Exception as e:  # noqa: BLE001 — answered, never a 500
            uid = ""
            if isinstance(review, dict):
                uid = (review.get("request") or {}).get("uid", "")
            out = {
                "apiVersion": "apiextensions.k8s.io/v1",
                "kind": "ConversionReview",
                "response": {
                    "uid": uid,
                    "result": {"status": "Failed", "message": str(e)},
                    "convertedObjects": [],
                },
            }
        return _json(out)

    def apply_poddefault(self, content_type: str, body: bytes) -> Response:
        if not content_type.startswith("application/json"):
            return _text("expected application/json", 415)
        try:
            review = json.loads(body.decode("utf-8", "replace"))
        except json.JSONDecodeError:
            return _text("bad json", 400)
        try:
            request = review.get("request") or {}
            namespace = (request.get("namespace")
                         or request.get("object", {})
                         .get("metadata", {}).get("namespace", ""))
            pod_defaults = (self.client.list(PODDEFAULT, namespace)
                            if namespace else [])
            out = mutate_admission_review(review, pod_defaults)
        except Exception as e:  # noqa: BLE001 — fail OPEN, as documented
            uid = (review.get("request") or {}).get("uid", "")
            out = {
                "apiVersion": review.get("apiVersion", "admission.k8s.io/v1"),
                "kind": "AdmissionReview",
                "response": {
                    "uid": uid,
                    "allowed": True,
                    "status": {"message": f"poddefault mutation skipped: {e}"},
                },
            }
        return _json(out)


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def _dispatch(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        status, headers, payload = self.server.app.handle(
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


class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
    """A threaded server whose connections each shake hands in their
    own thread, tracked so that ``close_all`` can end keep-alive
    connections at stop."""

    daemon_threads = True
    allow_reuse_address = True
    HANDSHAKE_S = 10.0

    def __init__(self, address, app, context: Optional[ssl.SSLContext]):
        self.app = app
        self.context = context
        self._lock = threading.Lock()
        self._conns = set()
        super().__init__(address, _Handler)

    def finish_request(self, request, client_address):
        # Runs in the connection's thread (ThreadingMixIn): a stalled
        # handshake holds this thread only.
        if self.context is None:
            conn = request
        else:
            try:
                request.settimeout(self.HANDSHAKE_S)
                conn = self.context.wrap_socket(request, server_side=True)
                conn.settimeout(None)
            except (OSError, ssl.SSLError) as e:
                log.debug("TLS handshake from %s failed: %s",
                          client_address, e)
                return
        with self._lock:
            self._conns.add(conn)
        try:
            self.RequestHandlerClass(conn, client_address, self)
        finally:
            with self._lock:
                self._conns.discard(conn)
            if conn is not request:
                conn.close()

    def handle_error(self, request, client_address):
        log.debug("connection from %s failed", client_address,
                  exc_info=True)

    def close_all(self) -> None:
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class WebhookServer:
    CERT_RELOAD_SECONDS = 60.0

    def __init__(self, client, *, host: str = "0.0.0.0", port: int = 4443,
                 cert_file: Optional[str] = None,
                 key_file: Optional[str] = None):
        self.app = WebhookApp(client)
        self._cert_file, self._key_file = cert_file, key_file
        self._cert_mtimes = self._mtimes()
        self._ctx = None
        if cert_file and key_file:
            self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ctx.load_cert_chain(cert_file, key_file)
        self._server = _Server((host, port), self.app, self._ctx)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Rotations that found an unloadable pair on disk (a torn write,
        # a key and cert from two pairs mid-rename): counted, not
        # swallowed.
        self.reload_failures = 0

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def _mtimes(self):
        out = []
        for path in (self._cert_file, self._key_file):
            try:
                out.append(os.stat(path).st_mtime if path else None)
            except OSError:
                out.append(None)
        return out

    def reload_certs(self) -> bool:
        """Load the pair on disk into the live context if it changed;
        new handshakes present it at once, no restart.  Returns True
        when a reload happened.  The poll calls it every
        ``CERT_RELOAD_SECONDS``; a caller that rotates calls it to
        rotate now."""
        current = self._mtimes()
        if current != self._cert_mtimes and all(current):
            try:
                # Trial-load on a scratch context first: a torn or
                # mismatched pair fails here, where it cannot poison the
                # serving context.
                probe = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                probe.load_cert_chain(self._cert_file, self._key_file)
                self._ctx.load_cert_chain(self._cert_file, self._key_file)
                self._cert_mtimes = current
                return True
            except (OSError, ssl.SSLError) as e:
                self.reload_failures += 1
                log.warning("cert reload failed (attempt %d; keeping the "
                            "previous pair): %s", self.reload_failures, e)
        return False

    def _cert_reload_loop(self) -> None:
        while not self._stop.wait(self.CERT_RELOAD_SECONDS):
            self.reload_certs()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="webhook", daemon=True)
        self._thread.start()
        if self._ctx is not None:
            threading.Thread(target=self._cert_reload_loop,
                             name="webhook-certs", daemon=True).start()

    def stop(self) -> None:
        """Stop serving and close every connection; on a server that was
        never started, only release its socket (``shutdown`` would wait
        for a ``serve_forever`` that never ran)."""
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._server.shutdown()
            self._thread.join(timeout=10)
        self._server.close_all()
        self._server.server_close()
