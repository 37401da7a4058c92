"""A small WSGI web framework on the standard library: routing,
blueprints, before/after hooks, JSON envelopes and error mapping.

The port's copy of ``kubeflow_tpu/platform/web/framework.py``, which
sits on werkzeug.  The card's machine has no werkzeug, so the request,
the response, the routing and the server are this module's own:

* ``Request``: ``method``, ``path``, ``args``, ``headers`` (case-
  insensitive), ``cookies``, ``content_type``, ``get_data()``,
  ``get_json()`` and the WSGI ``environ``;
* ``Response``: a body, a status and headers, ``content_type``,
  ``get_data``/``set_data`` and ``set_cookie`` (``SameSite``, ``Secure``,
  ``Path``); a WSGI application itself;
* the router keeps werkzeug's ``Map``/``Rule`` semantics: ``<name>``
  matches one non-empty segment and ``<path:name>`` the rest of the path
  (starting with anything but a slash); static segments are tried before
  converters and one-segment converters before ``path``; an unmatched
  path is a 404 and a matched path under another method a 405; ``HEAD``
  answers every ``GET`` rule with the body dropped; a rule with a
  trailing slash answers the bare path with a 308 to the slashed URL;
  and a path that matches only with runs of slashes merged answers with
  a 308 to the merged path.  Each reaches the client through
  ``failure()``, with werkzeug's descriptions;
* ``App`` is a WSGI callable (the request runs under the caller's
  ``traceparent``, ``telemetry/causal.py``), and ``serve()`` and
  ``test_server()`` run it on ``wsgiref`` with a thread a request and
  no request log.
"""
from __future__ import annotations

import json
import re
import threading
import traceback
import urllib.parse
from http import HTTPStatus
from socketserver import ThreadingMixIn
from typing import Any, Callable, Dict, List, Optional, Tuple
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

NOT_FOUND = ("The requested URL was not found on the server. If you entered "
             "the URL manually please check your spelling and try again.")
METHOD_NOT_ALLOWED = "The method is not allowed for the requested URL."


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


# -- request -----------------------------------------------------------------


class Headers:
    """A request's headers from its WSGI environ, looked up without
    regard to case."""

    def __init__(self, environ: dict):
        self._h: Dict[str, str] = {}
        for key, value in environ.items():
            if key.startswith("HTTP_"):
                self._h[key[5:].replace("_", "-").lower()] = value
            elif key in ("CONTENT_TYPE", "CONTENT_LENGTH") and value:
                self._h[key.replace("_", "-").lower()] = value

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self._h.get(name.lower(), default)


def parse_cookies(header: Optional[str]) -> Dict[str, str]:
    """``name=value`` pairs of a Cookie header; the first of a repeated
    name wins, a pair without ``=`` is skipped and a quoted value is
    unquoted."""
    out: Dict[str, str] = {}
    for part in (header or "").split(";"):
        name, eq, value = part.strip().partition("=")
        if not eq or not name:
            continue
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] == '"':
            value = value[1:-1]
        out.setdefault(name.strip(), value)
    return out


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = (environ.get("REQUEST_METHOD") or "GET").upper()
        # PATH_INFO holds the path's bytes as latin-1 (PEP 3333); the
        # path is their UTF-8 text.
        self.path = (environ.get("PATH_INFO") or "/").encode(
            "latin-1", "replace").decode("utf-8", "replace")
        # A repeated argument's first value, as werkzeug's ``args.get``.
        self.args: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(environ.get("QUERY_STRING", ""),
                                           keep_blank_values=True):
            self.args.setdefault(k, v)
        self.headers = Headers(environ)
        self.cookies = parse_cookies(environ.get("HTTP_COOKIE"))
        self._data: Optional[bytes] = None

    @property
    def content_type(self) -> Optional[str]:
        return self.environ.get("CONTENT_TYPE") or None

    def get_data(self, as_text: bool = False):
        if self._data is None:
            try:
                n = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                n = 0
            stream = self.environ.get("wsgi.input")
            self._data = stream.read(n) if (stream is not None and n > 0) \
                else b""
        return self._data.decode("utf-8", "replace") if as_text \
            else self._data

    def get_json(self, force: bool = False, silent: bool = False):
        """The body parsed as JSON.  Without ``force`` a body whose type
        is not JSON gives None; a body that does not parse gives None
        with ``silent`` and a 400 without."""
        ctype = (self.content_type or "").split(";")[0].strip().lower()
        if not force and not (ctype == "application/json"
                              or ctype.endswith("+json")):
            return None
        try:
            return json.loads(self.get_data(as_text=True))
        except ValueError:
            if silent:
                return None
            raise HttpError(400, "Failed to decode JSON object") from None


# -- response ----------------------------------------------------------------


def _status_line(code: int) -> str:
    try:
        phrase = HTTPStatus(code).phrase
    except ValueError:
        phrase = "UNKNOWN"
    return f"{code} {phrase.upper()}"


class Response:
    def __init__(self, body: Any = b"", status: int = 200, *,
                 headers: Optional[dict] = None,
                 content_type: str = "text/plain; charset=utf-8"):
        self.status_code = int(status)
        self.headers: List[Tuple[str, str]] = [("Content-Type", content_type)]
        for k, v in (headers or {}).items():
            self.headers.append((str(k), str(v)))
        self.set_data(body)

    @property
    def content_type(self) -> str:
        return self.header("Content-Type") or ""

    @property
    def status(self) -> str:
        return _status_line(self.status_code)

    def header(self, name: str) -> Optional[str]:
        for k, v in self.headers:
            if k.lower() == name.lower():
                return v
        return None

    def get_data(self, as_text: bool = False):
        return self._body.decode("utf-8") if as_text else self._body

    def set_data(self, body: Any) -> None:
        self._body = body.encode("utf-8") if isinstance(body, str) \
            else bytes(body)

    def set_cookie(self, key: str, value: str = "", *, path: str = "/",
                   secure: bool = False, httponly: bool = False,
                   samesite: Optional[str] = None) -> None:
        """A session cookie, its attributes in werkzeug's order."""
        parts = [f"{key}={value}"]
        if secure:
            parts.append("Secure")
        if httponly:
            parts.append("HttpOnly")
        if path:
            parts.append(f"Path={path}")
        if samesite:
            parts.append(f"SameSite={samesite.title()}")
        self.headers.append(("Set-Cookie", "; ".join(parts)))

    def __call__(self, environ, start_response):
        headers = [(k, v) for k, v in self.headers
                   if k.lower() != "content-length"]
        headers.insert(1, ("Content-Length", str(len(self._body))))
        start_response(self.status, headers)
        if (environ.get("REQUEST_METHOD", "").upper() == "HEAD"
                or self.status_code in (204, 304)):
            return []
        return [self._body]


def json_response(data: Any, status: int = 200, *,
                  headers: Optional[dict] = None) -> Response:
    from kubeflow_tpu_torch.platform.k8s.types import json_default

    # default hook: responses may embed frozen cache views (zero-copy
    # informer reads); serialize them without thawing.
    return Response(json.dumps(data, default=json_default), status,
                    headers=headers, content_type="application/json")


def success(data: Any = None, status: int = 200, **extra) -> Response:
    # The reference's envelope: {"success": true, "status": 200, ...}
    body = {"success": True, "status": status}
    if data is not None:
        body.update(data if isinstance(data, dict) else {"data": data})
    body.update(extra)
    return json_response(body, status)


def failure(message: str, status: int = 400,
            *, headers: Optional[dict] = None) -> Response:
    return json_response(
        {"success": False, "status": status, "log": message,
         "user_action": message},
        status, headers=headers,
    )


# -- routing -----------------------------------------------------------------


class _Redirect(HttpError):
    """A path answered by a 308 to ``url`` (werkzeug's RequestRedirect)."""

    def __init__(self, url: str):
        super().__init__(308, url)


_CONVERTER = re.compile(r"^<(?:(?P<conv>[a-z]+):)?(?P<name>[A-Za-z_]\w*)>$")
_ONE_SEGMENT = re.compile(r"[^/]+")
_PATH = re.compile(r"[^/].*?")


class _Rule:
    def __init__(self, rule: str, endpoint: str, methods: List[str]):
        if not rule.startswith("/"):
            raise ValueError(f"rule {rule!r} must start with a slash")
        self.rule = rule
        self.endpoint = endpoint
        self.methods = {m.upper() for m in methods}
        if "GET" in self.methods:
            self.methods.add("HEAD")
        self.names: List[str] = []
        self.parts: List[Tuple[str, str]] = []  # (kind, static text)
        segments = rule.split("/")[1:]
        for i, seg in enumerate(segments):
            m = _CONVERTER.match(seg)
            if m is None:
                if "<" in seg or ">" in seg:
                    raise ValueError(f"rule {rule!r}: a converter must fill "
                                     f"its segment")
                self.parts.append(("static", seg))
                continue
            conv = m.group("conv") or "default"
            if conv not in ("default", "path"):
                raise ValueError(f"rule {rule!r}: no converter {conv!r}")
            if conv == "path" and i != len(segments) - 1:
                raise ValueError(f"rule {rule!r}: <path:...> must be last")
            self.names.append(m.group("name"))
            self.parts.append(("path" if conv == "path" else "segment", ""))


class _State:
    __slots__ = ("static", "dynamic", "rules")

    def __init__(self):
        self.static: Dict[str, "_State"] = {}
        self.dynamic: List[Tuple[str, "_State"]] = []
        self.rules: List[_Rule] = []


class _NoMatch(Exception):
    def __init__(self, allowed: set):
        super().__init__()
        self.allowed = allowed


class _SlashRequired(Exception):
    pass


class Router:
    """werkzeug's state-machine matcher over path segments (the module's
    docstring lists the semantics kept)."""

    def __init__(self):
        self._root = _State()

    def add(self, rule: _Rule) -> None:
        state = self._root
        for kind, text in rule.parts:
            if kind == "static":
                state = state.static.setdefault(text, _State())
                continue
            for k, nxt in state.dynamic:
                if k == kind:
                    state = nxt
                    break
            else:
                nxt = _State()
                state.dynamic.append((kind, nxt))
                # One-segment converters are tried before ``path``.
                state.dynamic.sort(key=lambda e: e[0] == "path")
                state = nxt
        state.rules.append(rule)

    def _walk(self, parts: List[str], method: str, allowed: set):
        def match(state: _State, parts: List[str], values: List[str]):
            if not parts:
                for rule in state.rules:
                    if method not in rule.methods:
                        allowed.update(rule.methods)
                    else:
                        return rule, values
                slashed = state.static.get("")
                if slashed is not None:
                    for rule in slashed.rules:
                        if method in rule.methods:
                            raise _SlashRequired()
                return None
            part = parts[0]
            if part in state.static:
                rv = match(state.static[part], parts[1:], values)
                if rv is not None:
                    return rv
            for kind, nxt in state.dynamic:
                if kind == "path":
                    target, rest = "/".join(parts), []
                    ok = _PATH.fullmatch(target) is not None
                else:
                    target, rest = part, parts[1:]
                    ok = _ONE_SEGMENT.fullmatch(target) is not None
                if ok:
                    rv = match(nxt, rest, values + [target])
                    if rv is not None:
                        return rv
            return None

        return match(self._root, parts, [])

    def match(self, path: str, method: str) -> Tuple[_Rule, Dict[str, str]]:
        """(rule, arguments) of ``path`` under ``method``.  Raises
        ``RedirectTo`` where only the slashed or the slash-merged path
        matches, and ``_NoMatch`` (with the methods the path allows, for
        a 405) where nothing does."""
        path = "/" + path.lstrip("/")
        allowed: set = set()
        try:
            rv = self._walk(path.split("/")[1:], method, allowed)
        except _SlashRequired:
            raise RedirectTo(path + "/") from None
        if rv is None:
            merged = re.sub("/{2,}?", "/", path)
            if merged != path:
                try:
                    rv = self._walk(merged.split("/")[1:], method, allowed)
                except _SlashRequired:
                    raise RedirectTo(merged + "/") from None
                if rv is not None:
                    raise RedirectTo(merged)
            raise _NoMatch(allowed)
        rule, values = rv
        return rule, dict(zip(rule.names, values))


class RedirectTo(Exception):
    def __init__(self, path: str):
        super().__init__(path)
        self.path = path


def _redirect_url(environ: dict, path: str) -> str:
    """The absolute URL of ``path`` on the host the request named, with
    its query string (werkzeug's ``make_redirect_url``)."""
    scheme = environ.get("wsgi.url_scheme", "http")
    host = environ.get("HTTP_HOST")
    if not host:
        host = environ.get("SERVER_NAME", "localhost")
        port = environ.get("SERVER_PORT")
        if port:
            host = f"{host}:{port}"
    default = {"http": ":80", "https": ":443"}.get(scheme)
    if default and host.endswith(default):
        host = host[:-len(default)]
    script = (environ.get("SCRIPT_NAME") or "").rstrip("/")
    url = (f"{scheme}://{host}{script}/" +
           urllib.parse.quote(path.lstrip("/"), safe="/:@!$&'()*+,;=~"))
    query = environ.get("QUERY_STRING")
    return f"{url}?{query}" if query else url


# -- app ---------------------------------------------------------------------


class Blueprint:
    def __init__(self, name: str, url_prefix: str = ""):
        self.name = name
        self.url_prefix = url_prefix.rstrip("/")
        self.routes: List[Tuple[str, List[str], Callable]] = []

    def route(self, rule: str, methods: Optional[List[str]] = None):
        def deco(fn):
            self.routes.append((rule, methods or ["GET"], fn))
            return fn

        return deco


class App:
    def __init__(self, name: str):
        self.name = name
        self.router = Router()
        self._views: Dict[str, Callable] = {}
        self.before_request_hooks: List[Callable[[Request], Optional[Response]]] = []
        self.after_request_hooks: List[Callable[[Request, Response], Response]] = []
        self.config: Dict[str, Any] = {}

    # -- wiring --------------------------------------------------------------

    def _add(self, rule: str, endpoint: str, methods: List[str],
             fn: Callable) -> None:
        if endpoint in self._views and self._views[endpoint] is not fn:
            raise ValueError(f"endpoint {endpoint!r} is already taken")
        self.router.add(_Rule(rule, endpoint, methods))
        self._views[endpoint] = fn

    def register_blueprint(self, bp: Blueprint) -> None:
        for rule, methods, fn in bp.routes:
            self._add(bp.url_prefix + rule, f"{bp.name}.{fn.__name__}",
                      methods, fn)

    def route(self, rule: str, methods: Optional[List[str]] = None):
        def deco(fn):
            self._add(rule, fn.__name__, methods or ["GET"], fn)
            return fn

        return deco

    def before_request(self, fn):
        self.before_request_hooks.append(fn)
        return fn

    def after_request(self, fn):
        self.after_request_hooks.append(fn)
        return fn

    def match(self, request: Request) -> Tuple[_Rule, Dict[str, str]]:
        """The rule and arguments the request's path and method select;
        raises ``HttpError`` with the status werkzeug's adapter would
        (404, 405, or a 308 to the URL that matches)."""
        try:
            return self.router.match(request.path, request.method)
        except RedirectTo as e:
            raise _Redirect(_redirect_url(request.environ, e.path)) from None
        except _NoMatch as e:
            if e.allowed:
                raise HttpError(405, METHOD_NOT_ALLOWED) from None
            raise HttpError(404, NOT_FOUND) from None

    def view_of(self, request: Request) -> Optional[Callable]:
        """The view a request would reach; None where it reaches none."""
        try:
            rule, _ = self.match(request)
        except HttpError:
            return None
        return self._views.get(rule.endpoint)

    # -- wsgi ----------------------------------------------------------------

    def __call__(self, environ, start_response):
        from kubeflow_tpu_torch.telemetry import causal

        request = Request(environ)
        # An upstream traceparent header is the current context for the
        # whole request, so a create mints the new object's journey root
        # as a child of the caller's trace.
        ctx = causal.parse_traceparent(environ.get("HTTP_TRACEPARENT"))
        with causal.use(ctx):
            response = self._dispatch(request)
        return response(environ, start_response)

    def _dispatch(self, request: Request) -> Response:
        try:
            rule, args = self.match(request)
            # The matched rule pattern (e.g. "/api/namespaces/<ns>/
            # notebooks"): after_request hooks label per-kind counters
            # with it without re-parsing concrete paths.
            request.environ["kubeflow.route_rule"] = rule.rule
            for hook in self.before_request_hooks:
                early = hook(request)
                if early is not None:
                    response = early
                    break
            else:
                response = self._views[rule.endpoint](request, **args)
            if not isinstance(response, Response):
                response = json_response(response)
        except HttpError as e:
            response = failure(e.message, e.status)
        except Exception as e:
            # Kubernetes API errors keep their own status (409 AlreadyExists
            # on a duplicate spawn, 404, 403 ...); everything else is a 500.
            from kubeflow_tpu_torch.platform.k8s.errors import ApiError

            if isinstance(e, ApiError):
                headers = None
                if e.status in (429, 503):
                    # A transient upstream failure (throttling, or an
                    # unreachable API server): tell the client when to
                    # come back, honoring a server-sent Retry-After.
                    retry_after = getattr(e, "retry_after", None)
                    headers = {"Retry-After":
                               str(max(1, round(retry_after))
                                   if retry_after else 5)}
                response = failure(str(e), e.status, headers=headers)
            else:
                response = failure("internal error", 500)
                traceback.print_exc()
        for hook in self.after_request_hooks:
            response = hook(request, response)
        return response

    # -- serving -------------------------------------------------------------

    def make_server(self, host: str = "127.0.0.1", port: int = 0):
        """A threading ``wsgiref`` server of this app, not yet serving."""
        return make_server(host, port, self, server_class=_ThreadingServer,
                           handler_class=_QuietHandler)

    def serve(self, host: str = "0.0.0.0", port: int = 5000):
        """Blocking server (production runs behind the Istio gateway)."""
        self.make_server(host, port).serve_forever()

    def test_server(self, host: str = "127.0.0.1"):
        """(server, base_url) on an ephemeral port, running on a thread."""
        server = self.make_server(host, 0)
        t = threading.Thread(target=server.serve_forever, daemon=True,
                             name=f"{self.name}-http")
        t.start()
        return server, f"http://{host}:{server.server_port}"


class _ThreadingServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 — the base's name
        pass
