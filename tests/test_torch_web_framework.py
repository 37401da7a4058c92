"""The port's web framework (``kubeflow_tpu_torch/platform/web/
framework.py``, on the standard library) against the JAX package's (on
werkzeug): the same routes in both ``App``s, every case of a table of
(method, path, body, headers) driven through werkzeug's test ``Client``
(both are WSGI callables), with status, JSON body and the headers a
client reads compared exactly.  The cases reach werkzeug's routing
semantics (404, 405, ``HEAD``, the trailing-slash and merged-slash
redirects, ``<path:...>``), ``HttpError``, the API errors' own statuses
with ``Retry-After`` and a raised exception as 500; then the caller's
``traceparent`` in the handler, and ``test_server()`` over a socket."""
import json
import urllib.error
import urllib.request

import pytest
from werkzeug.test import Client

from kubeflow_tpu.platform.k8s import errors as ref_errors
from kubeflow_tpu.platform.web import framework as ref_framework
from kubeflow_tpu.telemetry import causal as ref_causal
from kubeflow_tpu_torch.platform.k8s import errors as port_errors
from kubeflow_tpu_torch.platform.web import framework as port_framework
from kubeflow_tpu_torch.telemetry import causal as port_causal

TRACE = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


def build(framework, errors, causal):
    """One app of ``framework`` with the routes the cases reach; a
    handler's errors come from the same package's ``errors``."""
    app = framework.App("table")
    bp = framework.Blueprint("bp", url_prefix="/bp/")

    @app.route("/a")
    def plain(request):
        return {"a": 1}

    @app.route("/echo", methods=["POST", "PUT", "PATCH", "DELETE"])
    def echo(request):
        return {"method": request.method, "path": request.path,
                "json": request.get_json(force=True, silent=True),
                "args": dict(request.args), "x": request.args.get("x"),
                "header": request.headers.get("X-Thing"),
                "type": request.content_type,
                "cookie": request.cookies.get("k")}

    @app.route("/slash/", methods=["GET", "POST"])
    def slash(request):
        return {"slash": True}

    @app.route("/item/<name>")
    def item(request, name):
        return {"name": name}

    @app.route("/item/<name>/", methods=["POST"])
    def item_slash(request, name):
        return {"post": name}

    @app.route("/item/<name>/sub/<kid>", methods=["GET", "DELETE"])
    def item_sub(request, name, kid):
        return {"name": name, "kid": kid, "method": request.method}

    @app.route("/files/<path:rest>")
    def files(request, rest):
        return {"rest": rest}

    @app.route("/static/exact")
    def static_first(request):
        return {"static": True}

    @app.route("/static/<name>")
    def static_second(request, name):
        return {"dynamic": name}

    @app.route("/http/<int_status>")
    def http_error(request, int_status):
        raise framework.HttpError(int(int_status), f"said {int_status}")

    @app.route("/api/<kind>")
    def api_error(request, kind):
        raise {
            "conflict": lambda: errors.AlreadyExists('"x" already exists'),
            "notfound": lambda: errors.NotFound('"x" not found'),
            "throttled": lambda: errors.TooManyRequests("slow down",
                                                        retry_after=2.6),
            "throttled-bare": lambda: errors.TooManyRequests("slow down"),
            "unavailable": lambda: errors.ServiceUnavailable("down"),
            "transport": lambda: errors.TransportError("no route"),
            "forbidden": lambda: errors.Forbidden("no"),
            "boom": lambda: RuntimeError("boom"),
            "key": lambda: KeyError("missing"),
        }[kind]()

    @app.route("/raw")
    def raw(request):
        return framework.json_response([1, 2], 201,
                                       headers={"X-Extra": "yes"})

    @app.route("/ok")
    def ok(request):
        return framework.success({"items": [1]}, extra="e")

    @app.route("/ok-list")
    def ok_list(request):
        return framework.success([3, 4])

    @app.route("/trace")
    def trace(request):
        return {"traceparent": causal.current_traceparent()}

    @bp.route("/thing", methods=["GET", "POST"])
    def thing(request):
        return {"bp": request.method}

    app.register_blueprint(bp)

    @app.before_request
    def gate(request):
        if request.headers.get("X-Deny"):
            return framework.failure("denied by hook", 418)
        return None

    @app.after_request
    def stamp(request, response):
        if isinstance(response.headers, list):  # the port's Response
            response.headers.append(("X-After", request.method))
        else:
            response.headers.add("X-After", request.method)
        return response

    return app


REF = build(ref_framework, ref_errors, ref_causal)
PORT = build(port_framework, port_errors, port_causal)

CASES = [
    # (method, path, json body, headers)
    ("GET", "/a", None, {}),
    ("HEAD", "/a", None, {}),
    ("POST", "/a", None, {}),
    ("PUT", "/a", None, {}),
    ("OPTIONS", "/a", None, {}),
    ("GET", "/a/", None, {}),
    ("GET", "/nope", None, {}),
    ("GET", "/", None, {}),
    ("GET", "/slash/", None, {}),
    ("GET", "/slash", None, {}),
    ("POST", "/slash", None, {}),
    ("HEAD", "/slash", None, {}),
    ("GET", "/slash?x=1&y=2", None, {}),
    ("DELETE", "/slash", None, {}),
    ("GET", "/item/abc", None, {}),
    ("GET", "/item/a%20b", None, {}),
    ("GET", "/item/caf%C3%A9", None, {}),
    ("GET", "/item/a%2Fb", None, {}),
    ("GET", "/item/", None, {}),
    ("GET", "/item/abc/", None, {}),
    ("POST", "/item/abc", None, {}),
    ("POST", "/item/abc/", None, {}),
    ("GET", "/item/abc/sub/k1", None, {}),
    ("DELETE", "/item/abc/sub/k1", None, {}),
    ("POST", "/item/abc/sub/k1", None, {}),
    ("GET", "/item/abc/sub/", None, {}),
    ("GET", "/item//abc", None, {}),
    ("GET", "/files/x", None, {}),
    ("GET", "/files/x/y/z.js", None, {}),
    ("GET", "/files/x/", None, {}),
    ("GET", "/files/", None, {}),
    ("GET", "/files//etc/passwd", None, {}),
    ("GET", "/files/a//b", None, {}),
    ("GET", "/files/%2e%2e/x", None, {}),
    ("GET", "/files/..%2Fx", None, {}),
    ("GET", "/files/a\\b", None, {}),
    ("GET", "/static/exact", None, {}),
    ("GET", "/static/other", None, {}),
    ("GET", "/http/400", None, {}),
    ("GET", "/http/403", None, {}),
    ("GET", "/http/409", None, {}),
    ("GET", "/http/500", None, {}),
    ("GET", "/api/conflict", None, {}),
    ("GET", "/api/notfound", None, {}),
    ("GET", "/api/throttled", None, {}),
    ("GET", "/api/throttled-bare", None, {}),
    ("GET", "/api/unavailable", None, {}),
    ("GET", "/api/transport", None, {}),
    ("GET", "/api/forbidden", None, {}),
    ("GET", "/api/boom", None, {}),
    ("GET", "/api/key", None, {}),
    ("HEAD", "/api/conflict", None, {}),
    ("GET", "/raw", None, {}),
    ("GET", "/ok", None, {}),
    ("GET", "/ok-list", None, {}),
    ("POST", "/echo", {"n": 1, "s": "x"}, {}),
    ("PUT", "/echo?x=1&x=2&y=", {"list": [1, 2]}, {"X-Thing": "t"}),
    ("PATCH", "/echo", None, {"x-thing": "lower"}),
    ("DELETE", "/echo", None, {}),
    ("POST", "/echo", "not json{", {}),
    ("GET", "/echo", None, {}),
    ("GET", "/a", None, {"X-Deny": "1"}),
    ("GET", "/nope", None, {"X-Deny": "1"}),
    ("GET", "/bp/thing", None, {}),
    ("POST", "/bp/thing", {"b": 1}, {}),
    ("PUT", "/bp/thing", None, {}),
    ("GET", "/a", None, {"Host": "example.com:8080"}),
    ("GET", "/slash", None, {"Host": "example.com:80"}),
    ("GET", "/slash", None, {"Host": "example.com:8080"}),
]


def run(app, method, path, body, headers):
    client = Client(app)
    kw = {"headers": headers}
    if isinstance(body, str):
        kw["data"] = body
    elif body is not None:
        kw["json"] = body
    return client.open(path, method=method, **kw)


def seen(resp):
    text = resp.get_data(as_text=True)
    try:
        body = json.loads(text) if text else None
    except ValueError:
        body = text
    headers = {k: resp.headers.get(k) for k in
               ("Content-Type", "Content-Length", "Retry-After", "X-Extra",
                "X-After", "Location")}
    return resp.status_code, body, headers


@pytest.mark.parametrize("method,path,body,headers", CASES,
                         ids=[f"{m} {p}" + (" +h" if h else "")
                              for m, p, _b, h in CASES])
def test_case_table_equals_the_reference(method, path, body, headers,
                                         capsys):
    ref = seen(run(REF, method, path, body, headers))
    got = seen(run(PORT, method, path, body, headers))
    assert got == ref
    # A raised non-API exception prints its traceback on both sides.
    out = capsys.readouterr()
    if path in ("/api/boom", "/api/key"):
        assert "Traceback" in out.err


def test_the_table_reaches_every_status():
    statuses = {seen(run(PORT, *case))[0] for case in CASES}
    assert {200, 201, 308, 400, 403, 404, 405, 409, 418, 429, 500,
            503} <= statuses


def test_cookies_reach_the_handler_as_the_reference_parses_them():
    for cookie in ("k=v1", "k=v1; k=v2", "a=1; k=\"quoted\"", "bad; k=v",
                   " k = spaced ", "k="):
        ref = Client(REF, use_cookies=False).post(
            "/echo", headers={"Cookie": cookie})
        got = Client(PORT, use_cookies=False).post(
            "/echo", headers={"Cookie": cookie})
        assert got.get_json()["cookie"] == ref.get_json()["cookie"], cookie


def test_traceparent_reaches_the_handler():
    for headers in ({"traceparent": TRACE}, {}, {"traceparent": "junk"}):
        ref = Client(REF).get("/trace", headers=headers).get_json()
        got = Client(PORT).get("/trace", headers=headers).get_json()
        assert got == ref
    assert got["traceparent"] is None
    got = Client(PORT).get("/trace", headers={"traceparent": TRACE})
    assert got.get_json() == {"traceparent": TRACE}
    # Nothing leaks past the request.
    assert port_causal.current() is None


def test_set_cookie_equals_werkzeug():
    from werkzeug.wrappers import Response as WzResponse

    for kw in ({}, {"secure": True, "samesite": "Strict", "path": "/"},
               {"httponly": True, "samesite": "lax", "path": "/x"},
               {"secure": True, "path": None}):
        wz = WzResponse()
        wz.set_cookie("XSRF-TOKEN", "abc", **kw)
        port = port_framework.Response()
        port.set_cookie("XSRF-TOKEN", "abc", **kw)
        assert port.header("Set-Cookie") == wz.headers["Set-Cookie"], kw


def test_rules_are_checked_when_added():
    app = port_framework.App("bad")
    for rule in ("no-slash", "/a/<path:p>/b", "/a/x<y>", "/a/<float:f>"):
        with pytest.raises(ValueError):
            app.route(rule)(lambda request: None)
    app.route("/dup")(lambda request: None)
    with pytest.raises(ValueError):
        app.route("/other")(lambda request: {"other": 1})


def _fetch(url, method="GET", data=None, headers=None):
    req = urllib.request.Request(url, method=method, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_test_server_answers_over_a_socket():
    ref_server, ref_base = REF.test_server()
    server, base = PORT.test_server()
    try:
        for method, path, data in [("GET", "/a", None),
                                   ("GET", "/nope", None),
                                   ("POST", "/a", None),
                                   ("HEAD", "/a", None),
                                   ("GET", "/api/throttled", None),
                                   ("POST", "/echo", b'{"n": 2}'),
                                   ("GET", "/trace", None)]:
            ref = _fetch(ref_base + path, method, data,
                         {"traceparent": TRACE})
            got = _fetch(base + path, method, data, {"traceparent": TRACE})
            assert got[0] == ref[0], path
            assert got[1] == ref[1], path
            for key in ("Content-Type", "Retry-After", "X-After"):
                assert got[2].get(key) == ref[2].get(key), (path, key)
        # The trailing-slash redirect names the host the client dialled.
        status, body, _ = _fetch(base + "/slash?x=1")
        assert status == 308
        assert json.loads(body)["log"] == base + "/slash/?x=1"
    finally:
        server.shutdown()
        server.server_close()
        ref_server.shutdown()
        ref_server.server_close()
