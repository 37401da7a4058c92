"""Static frontend serving for the platform web apps.

The port's copy of ``kubeflow_tpu/platform/web/static_serving.py``.  The
frontends are dependency-free ES modules served straight from
``kubeflow_tpu_torch/platform/frontend/``.  Each app serves:

    /                     -> frontend/<app>/index.html
    /app.js               -> frontend/<app>/app.js
    /shared/<file>        -> frontend/shared/<file>   (css + common js)

Static routes skip the authn gate (the SPA shell is public; every API
call it makes is authenticated and CSRF-checked as usual).  werkzeug's
``safe_join`` becomes ``safe_join`` here, as werkzeug's on POSIX: a name
that normalizes to ``..`` or under it, or an absolute name, is refused
with the same 404 as a missing file (a percent-encoded traversal
arrives decoded, so it is refused as a ``..``; a backslash is a plain
character of a name no file has).
"""
from __future__ import annotations

import mimetypes
import os
import posixpath
from typing import Optional

from kubeflow_tpu_torch.platform.web.crud_backend import no_authentication
from kubeflow_tpu_torch.platform.web.framework import (
    App,
    HttpError,
    Request,
    Response,
)

FRONTEND_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "frontend")

# ES modules refuse any other type; mimetypes guesses text/javascript on
# some systems.
_TYPES = {".js": "application/javascript; charset=utf-8"}


def safe_join(directory: str, filename: str) -> Optional[str]:
    """``directory``/``filename``, or None where the name would leave
    the directory."""
    if filename != "":
        filename = posixpath.normpath(filename)
    if (os.path.isabs(filename) or filename == ".."
            or filename.startswith("../")):
        return None
    return posixpath.join(directory, filename)


def _serve_file(root: str, filename: str) -> Response:
    path = safe_join(root, filename)
    if path is None or not os.path.isfile(path):
        raise HttpError(404, f"no such asset {filename!r}")
    content_type = (_TYPES.get(os.path.splitext(path)[1])
                    or mimetypes.guess_type(path)[0]
                    or "application/octet-stream")
    with open(path, "rb") as f:
        body = f.read()
    return Response(body, content_type=content_type)


def install_frontend(app: App, name: str, *, root: str = None) -> None:
    """Serve the named app's SPA (index.html, app.js, shared assets)."""
    root = root or FRONTEND_ROOT
    app_dir = os.path.join(root, name)
    shared_dir = os.path.join(root, "shared")

    @app.route("/")
    @no_authentication
    def index(request: Request):
        return _serve_file(app_dir, "index.html")

    @app.route("/app.js")
    @no_authentication
    def app_js(request: Request):
        return _serve_file(app_dir, "app.js")

    @app.route("/shared/<path:filename>")
    @no_authentication
    def shared(request: Request, filename: str):
        return _serve_file(shared_dir, filename)
