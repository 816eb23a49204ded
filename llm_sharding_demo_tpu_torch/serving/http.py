"""Minimal JSON-over-HTTP framework on the Python stdlib.

Counterpart of ``llm_sharding_demo_tpu/serving/http.py`` with the
request validation done by dataclasses and the standard library (no
pydantic): a route table, a threaded ``http.server`` runner, and an
in-process ``TestClient`` that runs the exact dispatch path.

POST handlers may annotate one parameter with a dataclass; the JSON body
is validated into it with pydantic v2's lax coercions, as the JAX app's
``model_validate`` does (numeric strings and integral floats to int,
numeric strings to float, ``1``/``"yes"``/``"off"``... to bool), and
answers HTTP 422 with pydantic's ``{"detail": [{"type", "loc", "msg",
"input"}, ...]}`` on failure; unknown keys are ignored. A handler that declares a ``headers`` parameter
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
import math
import re
import threading
import typing
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit


class ValidationError(Exception):
    def __init__(self, errors: List[dict]):
        super().__init__(str(errors))
        self.errors = errors


# pydantic v2's lax-mode coercions for the field types the request
# models use (int, float, bool, str, Optional[...], nested List[...]):
# what the JAX app's ``model_validate`` accepts, converts and refuses,
# with its error ``type``, ``loc`` (field first), ``msg`` and ``input``
_INT_STR = re.compile(r"[+-]?[0-9]+(_[0-9]+)*(\.0+)?")
_FLOAT_STR = re.compile(
    r"[+-]?(([0-9]+(_[0-9]+)*)?\.?[0-9]+(_[0-9]+)*|[0-9]+(_[0-9]+)*\.)"
    r"([eE][+-]?[0-9]+)?|[+-]?(inf|infinity|nan)", re.IGNORECASE)
_BOOL_STR = {"0": False, "off": False, "f": False, "false": False,
             "n": False, "no": False, "1": True, "on": True, "t": True,
             "true": True, "y": True, "yes": True}
# an integral float or an int past the i64 range is out of pydantic's
# int-from-float conversion and of its bool table
_I64 = 2 ** 63
_MSG = {
    "int_type": "Input should be a valid integer",
    "int_parsing": ("Input should be a valid integer, unable to parse "
                    "string as an integer"),
    "int_from_float": ("Input should be a valid integer, got a number with "
                       "a fractional part"),
    "int_parsing_size": ("Unable to parse input string as an integer, "
                         "exceeded maximum size"),
    "finite_number": "Input should be a finite number",
    "float_type": "Input should be a valid number",
    "float_parsing": ("Input should be a valid number, unable to parse "
                      "string as a number"),
    "bool_type": "Input should be a valid boolean",
    "bool_parsing": ("Input should be a valid boolean, unable to interpret "
                     "input"),
    "string_type": "Input should be a valid string",
    "list_type": "Input should be a valid list",
}


class _Invalid(Exception):
    def __init__(self, kind: str):
        super().__init__(kind)
        self.kind = kind


def _as_int(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if not math.isfinite(v):
            raise _Invalid("finite_number")
        if v != int(v):
            raise _Invalid("int_from_float")
        if abs(v) >= _I64:
            raise _Invalid("int_parsing_size")
        return int(v)
    if isinstance(v, str):
        t = v.strip()
        if not t.isascii() or not _INT_STR.fullmatch(t):
            raise _Invalid("int_parsing")
        return int(t.replace("_", "").split(".")[0])
    raise _Invalid("int_type")


def _as_float(v):
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str):
        t = v.strip()
        if not t.isascii() or not _FLOAT_STR.fullmatch(t):
            raise _Invalid("float_parsing")
        return float(t.replace("_", ""))
    raise _Invalid("float_type")


def _as_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v.lower() in _BOOL_STR:
            return _BOOL_STR[v.lower()]
        raise _Invalid("bool_parsing")
    if isinstance(v, float):
        if not math.isfinite(v) or v != int(v) or abs(v) >= _I64:
            raise _Invalid("bool_type")
        v = int(v)
    if isinstance(v, int):
        if v in (0, 1):
            return bool(v)
        raise _Invalid("bool_parsing" if abs(v) < _I64 else "bool_type")
    raise _Invalid("bool_type")


def _as_str(v):
    if isinstance(v, str):
        return v
    raise _Invalid("string_type")


_SCALARS = {int: _as_int, float: _as_float, bool: _as_bool, str: _as_str}


def _coerce(value, tp, loc: list, errors: List[dict]):
    """``value`` validated into ``tp`` the way pydantic's lax mode does;
    a failure appends its error entry (and the returned value is
    unused)."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = typing.get_args(tp)
        if value is None and type(None) in args:
            return None
        inner = [a for a in args if a is not type(None)]
        if len(inner) == 1:
            return _coerce(value, inner[0], loc, errors)
    if tp is list or origin in (list, List):
        if not isinstance(value, list):
            errors.append(_entry("list_type", loc, value))
            return value
        (item_tp,) = typing.get_args(tp) or (Any,)
        return [_coerce(v, item_tp, loc + [i], errors)
                for i, v in enumerate(value)]
    conv = _SCALARS.get(tp)
    if conv is None:
        return value
    try:
        return conv(value)
    except _Invalid as e:
        errors.append(_entry(e.kind, loc, value))
        return value


def _entry(kind: str, loc: list, value) -> dict:
    return {"type": kind, "loc": loc, "msg": _MSG[kind], "input": value}


def validate(model, payload):
    """JSON payload -> an instance of the dataclass ``model`` with
    pydantic's lax coercions (numeric strings, integral floats, bools as
    ints, its bool spellings); raises ``ValidationError`` with one entry
    per bad or missing field, in field order."""
    if not isinstance(payload, dict):
        raise ValidationError([{
            "type": "model_type", "loc": [],
            "msg": ("Input should be a valid dictionary or instance of "
                    f"{model.__name__}"),
            "input": payload, "ctx": {"class_name": model.__name__}}])
    hints = typing.get_type_hints(model)
    errors: List[dict] = []
    kwargs = {}
    for f in dataclasses.fields(model):
        if f.name not in payload:
            if (f.default is dataclasses.MISSING
                    and f.default_factory is dataclasses.MISSING):
                errors.append({"type": "missing", "loc": [f.name],
                               "msg": "Field required", "input": payload})
            continue
        kwargs[f.name] = _coerce(payload[f.name], hints[f.name], [f.name],
                                 errors)
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
