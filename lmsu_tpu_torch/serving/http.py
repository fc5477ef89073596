"""Stdlib HTTP front-end for the ServingEngine (no server dependencies).

Endpoints:
- ``POST /v1/predict[?output=logits|mask]`` — body is either an ``.npz``
  payload (``Content-Type: application/x-npz``; keys ``image`` [H,W,3]
  uint8/float, ``points`` [N,4] float, optional ``point_valid`` [N] bool)
  or JSON with the same keys as nested lists. Responds in kind: npz with
  key ``logits``/``mask``, or JSON. ``X-Serve-Ms`` carries the in-server
  wall time.
- ``GET /v1/stats`` — engine counters (throughput, occupancy, latency
  percentiles).
- ``GET /healthz`` — liveness.

Error mapping: malformed input 400; body over MAX_BODY_BYTES 413; engine
queue at its max_queue bound 503 (+Retry-After, load shedding); backend
failure 500.

ThreadingHTTPServer gives one thread per connection; request threads run
the engine's per-sample preprocessing concurrently and block on the
batched-forward future (the dynamic-batching engine turns those
concurrent blocked requests into full device batches).
"""

from __future__ import annotations

import io
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from lmsu_tpu_torch.serving.engine import EngineOverloaded, ServingEngine

NPZ_TYPE = "application/x-npz"
MAX_BODY_BYTES = 64 << 20  # one frame is ~0.3 MB npz; 64 MB is generous


class _BodyTooLarge(ValueError):
    pass


def _decode_body(handler: BaseHTTPRequestHandler):
    length = int(handler.headers.get("Content-Length", 0))
    if length > MAX_BODY_BYTES:
        raise _BodyTooLarge(
            f"request body {length} bytes exceeds the {MAX_BODY_BYTES}-byte "
            "limit")
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "")
    if ctype.startswith(NPZ_TYPE) or ctype.startswith("application/octet-stream"):
        with np.load(io.BytesIO(body)) as z:
            data = {k: z[k] for k in z.files}
        return data, "npz"
    data = json.loads(body.decode("utf-8"))
    img = np.asarray(data["image"])
    # JSON carries no dtype: integer pixels are uint8 by convention,
    # anything else is float32 in [0, 1].
    img = img.astype(np.uint8 if np.issubdtype(img.dtype, np.integer)
                     else np.float32)
    out = {"image": img,
           "points": np.asarray(data["points"], np.float32)}
    if "point_valid" in data and data["point_valid"] is not None:
        out["point_valid"] = np.asarray(data["point_valid"], bool)
    return out, "json"


def _encode_npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_handler(engine: ServingEngine):
    class Handler(BaseHTTPRequestHandler):
        # quiet by default; the serve CLI can flip this
        verbose = False

        def log_message(self, fmt, *args):
            if self.verbose:
                super().log_message(fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str,
                  extra_headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra_headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj, extra_headers=()) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json",
                       extra_headers)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send_json(200, {"ok": True})
            elif path == "/v1/stats":
                self._send_json(200, engine.stats())
            else:
                self._send_json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/v1/predict":
                self._send_json(404, {"error": f"unknown path {url.path}"})
                return
            try:
                data, kind = _decode_body(self)
                want = parse_qs(url.query).get("output", ["logits"])[0]
                t0 = time.monotonic()
                logits = engine.predict(
                    data["image"], data["points"], data.get("point_valid"))
                ms = (time.monotonic() - t0) * 1e3
            except _BodyTooLarge as e:
                self._send_json(413, {"error": str(e)})
                return
            except EngineOverloaded as e:
                self._send(503, json.dumps({"error": str(e)}).encode(),
                           "application/json", [("Retry-After", "1")])
                return
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # engine/backend failure
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            hdr = [("X-Serve-Ms", f"{ms:.3f}")]
            if want == "mask":
                mask = np.argmax(logits, axis=-1).astype(np.int32)
                if kind == "npz":
                    self._send(200, _encode_npz(mask=mask), NPZ_TYPE, hdr)
                else:
                    self._send_json(200, {"mask": mask.tolist()}, hdr)
            else:
                if kind == "npz":
                    self._send(200, _encode_npz(logits=logits), NPZ_TYPE, hdr)
                else:
                    self._send_json(200, {"logits": np.asarray(logits).tolist()},
                                    hdr)

    return Handler


def make_server(engine: ServingEngine, host: str = "127.0.0.1",
                port: int = 8765, verbose: bool = False) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; port 0 picks a free port
    (read it back from ``server.server_address``)."""
    handler = make_handler(engine)
    handler.verbose = verbose
    return ThreadingHTTPServer((host, port), handler)
