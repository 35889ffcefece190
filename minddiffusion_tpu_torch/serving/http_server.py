"""Minimal stdlib HTTP front end over serving.engine.BatchingEngine (port of
minddiffusion_tpu/serving/http_server.py, the same routes and codes).

POST /v1/txt2img   {"prompt": str, "negative_prompt": str?, "seed": int?}
                   -> {"image_png_b64": str, "latency_ms": float, "seed": int}
GET  /healthz      -> {"ok": true, "requests_served": N, "batches_run": N,
                       "queue_depth": N}
GET  /v1/info      -> the server's `info` dict

Status codes: 400 for a client error (bad JSON, a missing prompt, a seed
that is not an integer or that the adapter refuses), 500 for a
BatchExecutionError (a worker-side fault), 504 when the request times out.
A GLIDE reply lists the request fields the adapter ignores under `ignored`
(its negative_prompt).

Stdlib-only (http.server + ThreadingHTTPServer) so the serving stack carries
no web-framework dependency; concurrency comes from one thread per connection
all funneling into the engine's micro-batcher.
"""
from __future__ import annotations

import base64
import io
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from minddiffusion_tpu_torch.serving.engine import BatchExecutionError, BatchingEngine


def make_server(engine: BatchingEngine, host: str = "0.0.0.0",
                port: int = 8000, request_timeout: float = 600.0,
                info: Optional[dict] = None) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(200, {"ok": True,
                                 "requests_served": engine.requests_served,
                                 "batches_run": engine.batches_run,
                                 "queue_depth": engine.queue_depth})
            elif self.path == "/v1/info":
                self._send(200, info or {})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/txt2img":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                prompt = req["prompt"]
                negative = req.get("negative_prompt", "")
                seed_raw = req.get("seed", 0)
                if seed_raw is None:
                    seed_raw = 0
                if isinstance(seed_raw, bool) or not isinstance(
                        seed_raw, (int, str)):
                    raise ValueError(f"seed must be an integer, "
                                     f"got {type(seed_raw).__name__}")
                seed = int(seed_raw)  # int("") / int("x") raise -> 400
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            ignored = [k for k in getattr(engine.adapter, "IGNORED_PARAMS",
                                          ()) if req.get(k)]
            t0 = time.time()
            try:
                img = engine.submit(prompt, negative, seed,
                                    timeout=request_timeout)
            except BatchExecutionError as e:  # worker fault -> server error
                self._send(500, {"error": str(e)})
                return
            except ValueError as e:  # adapter.prepare validation (caller
                self._send(400, {"error": str(e)})   # thread, client input)
                return
            except TimeoutError:
                self._send(504, {"error": "generation timed out"})
                return
            except Exception as e:  # noqa: BLE001 — surface engine errors
                self._send(500, {"error": str(e)})
                return
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            resp = {
                "image_png_b64": base64.b64encode(buf.getvalue()).decode(),
                "latency_ms": round((time.time() - t0) * 1000, 1),
                "seed": seed,
            }
            if ignored:
                resp["ignored"] = ignored  # e.g. negative_prompt on GLIDE
            self._send(200, resp)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)
