"""Serve a ``FakeKube`` over HTTP with the API server's conventions.  The
port's copy of ``kubeflow_tpu/platform/testing/httpkube.py``, on the
standard library's ``http.server`` where the reference's runs on
werkzeug.

Every verb ``RestKubeClient`` speaks is served from the store: JSON
objects and lists, errors as JSON ``Status`` objects (with
``Retry-After`` when the error carries one), patches dispatched by
Content-Type, the status and log subresources, label, field and shard
selectors, SubjectAccessReviews, and watches as chunked streams of JSON
lines, one line a chunk, written at once and closed after
``timeoutSeconds``.  The server is threaded, speaks HTTP/1.1 keep-alive
(every non-watch response carries ``Content-Length``), sets
``TCP_NODELAY`` and binds ``127.0.0.1`` on a free port unless told
otherwise.  A watch whose client has gone ends within a poll, and
``stop`` ends every stream and connection.

Test infrastructure, not an API server: no auth (the SAR endpoint asks
``FakeKube.authz_policy``), HTTP only.  ``make_transport`` picks the
in-memory store or this wire for a harness::

    kube = FakeKube()
    client, server = make_transport(kube, "http")
    mgr = Manager(client, leader_election=True)
    ...
    server.stop()
"""
from __future__ import annotations

import dataclasses
import http.server
import json
import select
import socket
import socketserver
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import GVK, WELL_KNOWN
from kubeflow_tpu_torch.platform.runtime.sharding import ShardFilter

# RestKubeClient's PATCH Content-Type -> FakeKube's patch_type.
_PATCH_TYPES = {
    "application/merge-patch+json": "merge",
    "application/json-patch+json": "json",
    "application/strategic-merge-patch+json": "strategic",
}


def _parse_selector(raw: Optional[str]):
    if not raw:
        return None
    out = {}
    for part in raw.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out or None


class _Router:
    """Resolve an API path to (GVK, namespace, name, subresource)."""

    def __init__(self):
        self._by_plural = {}
        self._by_group_plural = {}
        for gvk in WELL_KNOWN:
            self._by_plural[(gvk.group, gvk.version, gvk.plural)] = gvk
            # A SAR carries group and resource, no version.
            self._by_group_plural[(gvk.group, gvk.plural)] = gvk

    def for_sar(self, group: str, plural: str) -> GVK:
        gvk = self._by_group_plural.get((group, plural))
        # An unknown kind still makes an attribute bag for the policy.
        return gvk if gvk is not None else GVK(group, "v1", plural, plural)

    def resolve(self, path: str) -> Tuple[GVK, Optional[str], Optional[str], str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise errors.NotFound("not an API path")
        if parts[0] == "api":
            group, rest = "", parts[1:]
        elif parts[0] == "apis" and len(parts) > 1:
            group, rest = parts[1], parts[2:]
        else:
            raise errors.NotFound(f"unknown API root {parts[0]!r}")
        if not rest:
            raise errors.NotFound("missing API version")
        version, rest = rest[0], rest[1:]
        namespace = None
        # "/api/v1/namespaces[/<name>]" is the Namespace kind itself; a
        # longer tail is a namespaced kind's path.
        if len(rest) > 2 and rest[0] == "namespaces":
            namespace, rest = rest[1], rest[2:]
        if not rest:
            raise errors.NotFound("missing resource")
        plural, rest = rest[0], rest[1:]
        gvk = self._by_plural.get((group, version, plural))
        if gvk is None:
            raise errors.NotFound(
                f"the server could not find the requested resource "
                f"({group}/{version} {plural})")
        name = rest[0] if rest else None
        sub = rest[1] if len(rest) > 1 else ""
        return gvk, namespace, name, sub


@dataclasses.dataclass
class Reply:
    """One response: a whole ``body``, or a ``stream`` of lines that
    ends when ``stop`` is set or the store's watch ends."""

    status: int
    headers: List[Tuple[str, str]]
    body: bytes = b""
    stream: Optional[Iterator[bytes]] = None
    stop: Optional[threading.Event] = None
    deadline: float = 0.0


class HttpKube:
    """The API routes over a FakeKube, independent of the HTTP server:
    ``handle`` maps one request to a ``Reply``."""

    def __init__(self, kube):
        self.kube = kube
        self.router = _Router()

    def handle(self, method: str, path: str, query: str,
               headers, body: bytes) -> Reply:
        from kubeflow_tpu_torch.telemetry import causal

        try:
            # The request's traceparent is the handler's context, so the
            # store's first-admission mint inherits the caller's trace.
            ctx = causal.parse_traceparent(headers.get("traceparent"))
            with causal.use(ctx):
                return self._dispatch(method, path, query, headers, body)
        except Exception as e:
            if not isinstance(e, errors.ApiError):
                # A fault of the store (a JSON patch that does not apply)
                # answers 500 with a Status, never a dropped connection.
                e = errors.InternalError(f"{type(e).__name__}: {e}")
            out = json.dumps(e.to_status()).encode()
            hdrs = [("Content-Type", "application/json")]
            if e.retry_after is not None:
                # An injected 429/503 carries its backpressure hint
                # across, so the client's Retry-After path runs end to end.
                hdrs.append(("Retry-After", str(e.retry_after)))
            return Reply(e.status, hdrs, out)

    def _dispatch(self, method, path, query, headers, body) -> Reply:
        params = {k: v[0] for k, v in parse_qs(query).items()}
        if method == "POST" and path.rstrip("/").endswith(
                "/subjectaccessreviews"):
            return self._sar(body)
        gvk, namespace, name, sub = self.router.resolve(path)
        if method == "GET" and sub == "log":
            text = self.kube.pod_logs(name, namespace,
                                      container=params.get("container"))
            return Reply(200, [("Content-Type", "text/plain")],
                         text.encode())
        if method == "GET" and params.get("watch") == "true":
            return self._watch(gvk, namespace, params)
        if method == "GET" and name:
            return self._json(self.kube.get(gvk, name, namespace))
        if method == "GET":
            from kubeflow_tpu_torch.platform.k8s.types import match_labels
            from kubeflow_tpu_torch.platform.testing.fake import _match_fields

            # One snapshot: the items and the version come from one
            # locked list, and the selectors filter here.
            items, rv = self.kube.list_with_rv(gvk, namespace)
            label = _parse_selector(params.get("labelSelector"))
            field = _parse_selector(params.get("fieldSelector"))
            filt = ShardFilter.parse(params.get("shardFilter"))
            if label:
                items = [o for o in items if match_labels(o, label)]
            if field:
                items = [o for o in items if _match_fields(o, field)]
            if filt is not None:
                # The shard range is cut before serialization: a ranged
                # relist ships only the subscribed range's bytes.
                items = [o for o in items if filt.admits(o)]
            return self._json({"kind": gvk.kind + "List",
                               "apiVersion": gvk.api_version,
                               "metadata": {"resourceVersion": rv},
                               "items": items})
        if method == "POST":
            out = self.kube.create(self._body(body),
                                   dry_run=params.get("dryRun") == "All")
            return self._json(out, status=201)
        if method == "PUT":
            obj = self._body(body)
            if sub == "status":
                return self._json(self.kube.update_status(obj))
            return self._json(self.kube.update(obj))
        if method == "PATCH":
            ptype = _PATCH_TYPES.get(
                (headers.get("Content-Type") or "").split(";")[0].strip())
            if ptype is None:
                raise errors.BadRequest("unsupported patch content type")
            fn = self.kube.patch_status if sub == "status" else self.kube.patch
            return self._json(fn(gvk, name, self._body(body), namespace,
                                 patch_type=ptype))
        if method == "DELETE":
            opts = self._body(body, optional=True) or {}
            self.kube.delete(
                gvk, name, namespace,
                propagation=opts.get("propagationPolicy", "Background"))
            return self._json({"kind": "Status", "apiVersion": "v1",
                               "status": "Success"})
        raise errors.BadRequest(f"unsupported method {method}")

    def _sar(self, body: bytes) -> Reply:
        review = self._body(body)
        spec = review.get("spec") or {}
        attrs = spec.get("resourceAttributes") or {}
        gvk = self.router.for_sar(attrs.get("group", ""),
                                  attrs.get("resource", ""))
        allowed = self.kube.can_i(
            spec.get("user", ""), attrs.get("verb", ""), gvk,
            attrs.get("namespace") or None,
            groups=spec.get("groups") or [],
            subresource=attrs.get("subresource", ""))
        review = dict(review)
        review["status"] = {"allowed": bool(allowed)}
        return self._json(review, status=201)

    def _watch(self, gvk, namespace, params) -> Reply:
        stop = threading.Event()
        # The store registers the watcher now, before the reply goes out:
        # no event between the client's list and this call is lost.
        events = self.kube.watch(
            gvk, namespace, resource_version=params.get("resourceVersion"),
            label_selector=_parse_selector(params.get("labelSelector")),
            shard_filter=params.get("shardFilter"), stop=stop)

        def lines() -> Iterator[bytes]:
            for etype, obj in events:
                yield json.dumps({"type": etype, "object": obj}).encode() \
                    + b"\n"

        window = float(params.get("timeoutSeconds", "300"))
        return Reply(200, [("Content-Type", "application/json")],
                     stream=lines(), stop=stop,
                     deadline=time.monotonic() + window)

    @staticmethod
    def _body(raw: bytes, optional: bool = False):
        if not raw:
            if optional:
                return None
            raise errors.BadRequest("request body required")
        try:
            return json.loads(raw)
        except ValueError:
            raise errors.BadRequest("invalid JSON body") from None

    @staticmethod
    def _json(obj, status: int = 200) -> Reply:
        return Reply(status, [("Content-Type", "application/json")],
                     json.dumps(obj).encode())


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Each watch pushes many small lines down one connection: without
    # TCP_NODELAY each risks a Nagle and delayed-ACK stall.
    disable_nagle_algorithm = True
    # An idle keep-alive connection is closed after this many seconds; the
    # client finds it closed before reusing it.
    timeout = 60

    def _serve(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length > 0 else b""
        url = urlsplit(self.path)
        reply = self.server.app.handle(self.command, url.path, url.query,
                                       self.headers, body)
        self.send_response(reply.status)
        for k, v in reply.headers:
            self.send_header(k, v)
        if reply.stream is None:
            self.send_header("Content-Length", str(len(reply.body)))
            self.end_headers()
            self.wfile.write(reply.body)
            return
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.server.track_watch(reply, self.connection)
        try:
            for line in reply.stream:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            self.close_connection = True  # the client has gone
        finally:
            reply.stop.set()
            self.server.untrack_watch(reply)

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _serve

    def log_message(self, format, *args) -> None:
        pass  # a request log per call would drown a test's output


class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    block_on_close = False
    POLL_S = 0.1

    def __init__(self, address, app: HttpKube):
        super().__init__(address, _Handler)
        self.app = app
        self._lock = threading.Lock()
        self._conns: set = set()
        self._watches: Dict[int, Tuple[Reply, socket.socket]] = {}
        self._closing = threading.Event()
        self._reaper = threading.Thread(target=self._reap,
                                        name="httpkube-watches", daemon=True)
        self._reaper.start()

    def process_request(self, request, client_address):
        with self._lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def track_watch(self, reply: Reply, sock: socket.socket) -> None:
        with self._lock:
            self._watches[id(reply)] = (reply, sock)

    def untrack_watch(self, reply: Reply) -> None:
        with self._lock:
            self._watches.pop(id(reply), None)

    @staticmethod
    def _client_gone(sock: socket.socket) -> bool:
        """A watch's client sends nothing after its request: a readable
        socket that reads as EOF is a closed client."""
        try:
            ready, _, _ = select.select([sock], [], [], 0)
            return bool(ready) and sock.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _reap(self) -> None:
        """End each watch at its window's end or when its client has
        gone (the store's stream notices its stop within a poll)."""
        while not self._closing.wait(self.POLL_S):
            now = time.monotonic()
            with self._lock:
                live = list(self._watches.values())
            for reply, sock in live:
                if now >= reply.deadline or self._client_gone(sock):
                    reply.stop.set()

    def close_all(self) -> None:
        self._closing.set()
        with self._lock:
            watches = [r for r, _ in self._watches.values()]
            conns = list(self._conns)
        for reply in watches:
            reply.stop.set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class HttpKubeServer:
    """A threaded HTTP server for HttpKube; a watch holds a thread."""

    def __init__(self, kube, host: str = "127.0.0.1", port: int = 0):
        self.app = HttpKube(kube)
        self._server = _Server((host, port), self.app)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="httpkube", daemon=True)

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "HttpKubeServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving, end every watch and close every connection."""
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.close_all()
        self._server.server_close()


def make_transport(kube, transport: str, *, watch_window: float = None):
    """A harness's transport: ``memory`` returns the store itself as the
    client; ``http`` serves it over a socket and returns a
    ``RestKubeClient`` (``watch_window`` shortens the client's watch
    windows: every watch closes and resumes that often).  Returns
    ``(client, server or None)``; the caller stops the server."""
    if transport == "memory":
        if watch_window is not None:
            raise ValueError(
                "watch_window only applies to the http transport: a "
                "memory-transport harness would skip the resume path it "
                "was asked to stress")
        return kube, None
    if transport == "http":
        from kubeflow_tpu_torch.platform.k8s.client import RestKubeClient

        server = HttpKubeServer(kube).start()
        client = RestKubeClient(server.base_url)
        if watch_window is not None:
            client.WATCH_TIMEOUT_SECONDS = watch_window
        return client, server
    raise ValueError(f"unknown transport {transport!r}")
