"""Minimal JSON-over-HTTP framework on the Python stdlib.

Counterpart of ``llm_sharding_demo_tpu/serving/http.py`` with the
request validation done by dataclasses and the standard library (no
pydantic): a route table, a threaded ``http.server`` runner, and an
in-process ``TestClient`` that runs the exact dispatch path.

POST handlers may annotate one parameter with a dataclass; the JSON body
is validated into it (HTTP 422 with ``{"detail": [...]}`` on failure,
unknown keys ignored). A handler that declares a ``headers`` parameter
receives the request headers as a dict with lower-cased names, one that
declares ``query`` the query string's parameters. Handlers return a
payload (200), ``(status, payload)`` or ``(status, payload, headers)``:
a dict is sent as JSON, a string as text (the Prometheus exposition);
an uncaught exception answers 500.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import typing
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit


class ValidationError(Exception):
    def __init__(self, errors: List[dict]):
        super().__init__(str(errors))
        self.errors = errors


def _check_type(value, tp, loc: list, errors: List[dict]) -> None:
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = typing.get_args(tp)
        if value is None and type(None) in args:
            return
        inner = [a for a in args if a is not type(None)]
        if len(inner) == 1:
            _check_type(value, inner[0], loc, errors)
            return
    if origin in (list, List):
        if not isinstance(value, list):
            errors.append({"loc": loc, "msg": "Input should be a valid list"})
            return
        (item_tp,) = typing.get_args(tp) or (Any,)
        for i, v in enumerate(value):
            _check_type(v, item_tp, loc + [i], errors)
        return
    ok = {
        int: lambda v: isinstance(v, int) and not isinstance(v, bool),
        float: lambda v: (isinstance(v, (int, float))
                          and not isinstance(v, bool)),
        str: lambda v: isinstance(v, str),
        bool: lambda v: isinstance(v, bool),
        list: lambda v: isinstance(v, list),
    }.get(tp, lambda v: True)
    if not ok(value):
        name = getattr(tp, "__name__", str(tp))
        errors.append({"loc": loc, "msg": f"Input should be a valid {name}"})


def validate(model, payload):
    """JSON payload -> an instance of the dataclass ``model``; raises
    ``ValidationError`` with one entry per bad or missing field."""
    if not isinstance(payload, dict):
        raise ValidationError([{"loc": ["body"],
                                "msg": "Input should be a valid dictionary"}])
    hints = typing.get_type_hints(model)
    errors: List[dict] = []
    kwargs = {}
    for f in dataclasses.fields(model):
        if f.name not in payload:
            if (f.default is dataclasses.MISSING
                    and f.default_factory is dataclasses.MISSING):
                errors.append({"loc": ["body", f.name],
                               "msg": "Field required"})
            continue
        value = payload[f.name]
        _check_type(value, hints[f.name], ["body", f.name], errors)
        if hints[f.name] is float and isinstance(value, int):
            value = float(value)
        kwargs[f.name] = value
    if errors:
        raise ValidationError(errors)
    return model(**kwargs)


class JSONApp:
    """Route table: (method, path) -> handler."""

    def __init__(self, title: str = "", version: str = ""):
        self.title = title
        self.version = version
        self._routes: Dict[Tuple[str, str], Callable] = {}

    def get(self, path: str):
        return self._register("GET", path)

    def post(self, path: str):
        return self._register("POST", path)

    def _register(self, method: str, path: str):
        def deco(fn):
            self._routes[(method, path)] = fn
            return fn
        return deco

    def handle(self, method: str, path: str, body: Optional[bytes],
               headers: Optional[Dict[str, str]] = None,
               ) -> Tuple[int, Any, Dict[str, str]]:
        """``(status, payload, response headers)`` of one request."""
        parts = urlsplit(path)
        route_path = parts.path
        fn = self._routes.get((method, route_path))
        if fn is None:
            if any(p == route_path for (_, p) in self._routes):
                return 405, {"detail": "Method Not Allowed"}, {}
            return 404, {"detail": "Not Found"}, {}

        kwargs = {}
        code = fn.__code__
        arg_names = code.co_varnames[:code.co_argcount]
        if "headers" in arg_names:
            kwargs["headers"] = {k.lower(): v
                                 for k, v in (headers or {}).items()}
        if "query" in arg_names:
            kwargs["query"] = dict(parse_qsl(parts.query))
        args = []
        hints = {k: v for k, v in typing.get_type_hints(fn).items()
                 if k not in ("return", "headers", "query")}
        if hints:
            model = next(iter(hints.values()))
            if dataclasses.is_dataclass(model):
                try:
                    payload = json.loads(body or b"null")
                except json.JSONDecodeError:
                    return 422, {"detail": "invalid JSON body"}, {}
                try:
                    args.append(validate(model, payload))
                except ValidationError as e:
                    return 422, {"detail": e.errors}, {}
        try:
            result = fn(*args, **kwargs)
        except Exception as e:  # uncaught handler error -> 500
            logging.getLogger(__name__).exception("handler %s failed",
                                                  route_path)
            return 500, {"detail": f"{type(e).__name__}: {e}"}, {}
        if (isinstance(result, tuple) and len(result) in (2, 3)
                and isinstance(result[0], int)):
            return (*result[:2], dict(result[2]) if len(result) == 3 else {})
        return 200, result, {}


class Response:
    """requests-compatible view of a handled call."""

    def __init__(self, status_code: int, payload: Any,
                 headers: Optional[Dict[str, str]] = None):
        self.status_code = status_code
        self._payload = payload
        self.headers = dict(headers or {})
        self.text = (payload if isinstance(payload, str)
                     else json.dumps(payload))

    def json(self) -> Any:
        if isinstance(self._payload, str):
            raise ValueError("response is text, not JSON")
        return self._payload


class TestClient:
    """In-process client running the exact server dispatch path."""

    __test__ = False  # not a pytest collection target

    def __init__(self, app: JSONApp):
        self.app = app

    def get(self, path: str,
            headers: Optional[Dict[str, str]] = None) -> Response:
        return Response(*self.app.handle("GET", path, None, headers))

    def post(self, path: str, json: Any = None,  # noqa: A002
             headers: Optional[Dict[str, str]] = None,
             timeout_s: Optional[float] = None) -> Response:
        """``timeout_s`` is the wire timeout a socket client takes; the
        in-process call is synchronous and ignores it."""
        del timeout_s
        import json as _json
        return Response(*self.app.handle(
            "POST", path, _json.dumps(json).encode(), headers))


def serve(app: JSONApp, host: str = "0.0.0.0", port: int = 5000,
          block: bool = True) -> ThreadingHTTPServer:
    """Serve over real sockets (threaded, one request per thread).

    With ``block=False`` the server runs on a daemon thread and is
    returned at once; the caller stops it with ``shutdown()`` (its bound
    port is ``server_address[1]``, so ``port=0`` takes a free one)."""

    class Handler(BaseHTTPRequestHandler):
        def _dispatch(self, method: str):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else None
            status, payload, headers = app.handle(
                method, self.path, body, dict(self.headers.items()))
            if isinstance(payload, str):
                data = payload.encode()
                ctype = "text/plain; version=0.0.4"  # Prometheus text
            else:
                data = json.dumps(payload).encode()
                ctype = "application/json"
            self.send_response(status)
            for name, value in headers.items():
                self.send_header(name, value)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (stdlib naming)
            self._dispatch("GET")

        def do_POST(self):  # noqa: N802
            self._dispatch("POST")

        def log_message(self, fmt, *args):
            logging.getLogger("llm_sharding_demo_tpu_torch.serving").info(
                "%s %s", self.address_string(), fmt % args)

    class Server(ThreadingHTTPServer):
        # the listen backlog: the socketserver default of 5 drops the
        # connects of a burst of concurrent clients (a batched server's
        # whole point), which then retry a second later
        request_queue_size = 128

    server = Server((host, port), Handler)
    if block:
        with server:
            server.serve_forever()
        return server
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
