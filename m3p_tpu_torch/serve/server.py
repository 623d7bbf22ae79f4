"""JSON-over-HTTP serving frontend of the port (stdlib only; counterpart of
`m3p_tpu/serve/server.py` with the same contract).

Endpoints (POST bodies and responses are JSON):
  GET  /health        -> {"status": "ok", ...engine stats}
  POST /v1/score      {"pairs": [{"text": ..., <image payload>}, ...]}
                      -> {"scores": [float, ...]}
  POST /v1/retrieve   {"text": ..., "top_k": 10}
                      -> {"results": [{"id": ..., "score": ...}, ...]}
  POST /v1/caption    {"images": [<image payload>, ...], "lang": "en",
                       "beam_size": 5, "max_len": 20}
                      -> {"captions": [str, ...]}
  POST /v1/translate  {"texts": [...], "src_lang": "en", "tgt_lang": "de"}
                      -> {"translations": [str, ...]}

An image payload is inline {"feats": [[...]], "locs": [[...]]} or
{"features": ..., "boxes": ..., "wh": [h, w]} arrays, or {"image_id": ...}
when the engine has a feature store.

Single-pair /v1/score and single-image default-config /v1/caption requests
are coalesced across concurrent clients by a `MicroBatcher`; multi-item,
custom-config, translation and retrieval requests run on a serial
direct-runner under the same max_pending/timeout admission control (429 /
503).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from m3p_tpu_torch.serve.batcher import MicroBatcher, QueueFull, RequestTimeout
from m3p_tpu_torch.serve.engine import InferenceEngine

logger = logging.getLogger("m3p_tpu_torch")


class ServeApp:
    """Routes requests to the engine; owns the per-endpoint micro-batchers.

    Robustness contract: malformed JSON / wrong-shape payloads -> 400;
    bodies over ``max_body_bytes`` -> 413 (rejected before reading);
    batcher backlog beyond ``max_pending`` -> 429 (backpressure, the client
    should retry later); request exceeding ``request_timeout_s`` -> 503;
    anything unexpected -> 500 with the error text, and the server keeps
    serving."""

    def __init__(self, engine: InferenceEngine, max_batch: int = 64,
                 max_wait_s: float = 0.005,
                 request_timeout_s: float = 120.0,
                 max_pending: int = 1024,
                 max_body_bytes: int = 32 * 1024 * 1024):
        self.engine = engine
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = max_body_bytes
        self._score_batcher = MicroBatcher(
            self._score_handler, max_batch=max_batch, max_wait_s=max_wait_s,
            name="score-batcher", max_pending=max_pending)
        self._caption_batcher = MicroBatcher(
            self._caption_handler, max_batch=max_batch,
            max_wait_s=max_wait_s, name="caption-batcher",
            max_pending=max_pending)
        # multi-item and custom-config requests are already device batches;
        # they run through this serial thunk runner so the SAME max_pending
        # (429) and request_timeout_s (503) admission control covers them —
        # calling the engine straight from ThreadingHTTPServer handler
        # threads would let the expensive requests bypass both bounds
        self._direct_runner = MicroBatcher(
            lambda thunks: [t() for t in thunks], max_batch=1,
            max_wait_s=0.0, name="direct-runner", max_pending=max_pending)

    def _direct(self, thunk):
        return self._direct_runner(thunk, timeout=self.request_timeout_s)

    def close(self) -> None:
        self._score_batcher.stop()
        self._caption_batcher.stop()
        self._direct_runner.stop()

    # -- batched handlers (run on the batcher threads) --------------------

    def _score_handler(self, items: List[Dict[str, Any]]) -> List[float]:
        texts = [it["text"] for it in items]
        images = [{k: v for k, v in it.items() if k != "text"}
                  for it in items]
        return self.engine.score(texts, images)

    def _caption_handler(self, items: List[Dict[str, Any]]) -> List[str]:
        return self.engine.caption(items)

    # -- routes ------------------------------------------------------------

    def handle(self, method: str, path: str, body: Optional[Dict[str, Any]]
               ) -> Tuple[int, Dict[str, Any]]:
        try:
            if method == "GET" and path == "/health":
                return 200, {"status": "ok", **self.engine.stats()}
            if method != "POST" or body is None:
                return 404, {"error": f"no route {method} {path}"}
            if path == "/v1/score":
                pairs = body["pairs"]
                if len(pairs) == 1:
                    score = self._score_batcher(
                        pairs[0], timeout=self.request_timeout_s)
                    return 200, {"scores": [score]}
                texts = [p["text"] for p in pairs]
                images = [{k: v for k, v in p.items() if k != "text"}
                          for p in pairs]
                return 200, {"scores": self._direct(
                    lambda: self.engine.score(texts, images))}
            if path == "/v1/retrieve":
                return 200, {"results": self._direct(
                    lambda: self.engine.retrieve(
                        body["text"], top_k=int(body.get("top_k", 10))))}
            if path == "/v1/caption":
                images = body["images"]
                custom = ("lang" in body or "beam_size" in body
                          or "max_len" in body)
                if len(images) == 1 and not custom:
                    cap = self._caption_batcher(
                        images[0], timeout=self.request_timeout_s)
                    return 200, {"captions": [cap]}
                return 200, {"captions": self._direct(
                    lambda: self.engine.caption(
                        images, lang=body.get("lang"),
                        beam_size=body.get("beam_size"),
                        max_len=body.get("max_len")))}
            if path == "/v1/translate":
                return 200, {"translations": self._direct(
                    lambda: self.engine.translate(
                        body["texts"], tgt_lang=body["tgt_lang"],
                        src_lang=body.get("src_lang"),
                        beam_size=body.get("beam_size"),
                        max_len=body.get("max_len")))}
            return 404, {"error": f"no route {method} {path}"}
        except QueueFull as e:
            return 429, {"error": f"overloaded: {e}"}
        except RequestTimeout:
            # only genuine WAIT timeouts land here — an engine-raised
            # TimeoutError (builtin alias of concurrent.futures.TimeoutError
            # on py>=3.11) falls through to the 500 handler with its real
            # message instead of masquerading as a request timeout
            return 503, {"error": "request timed out "
                                  f"({self.request_timeout_s}s)"}
        except (KeyError, ValueError, TypeError) as e:
            return 400, {"error": f"{type(e).__name__}: {e}"}
        except Exception as e:  # noqa: BLE001 — report, keep serving
            logger.exception("request failed: %s %s", method, path)
            return 500, {"error": f"{type(e).__name__}: {e}"}


class _Handler(BaseHTTPRequestHandler):
    app: ServeApp  # set by make_server

    def _reply(self, status: int, payload: Dict[str, Any]) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        status, payload = self.app.handle("GET", self.path, None)
        self._reply(status, payload)

    def do_POST(self) -> None:  # noqa: N802
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._reply(400, {"error": "bad Content-Length"})
            return
        if length < 0:
            # a negative length would turn rfile.read(length) into
            # read-until-EOF on a connection the client controls — a
            # thread-leak, not a body
            self._reply(400, {"error": "bad Content-Length"})
            return
        if length > self.app.max_body_bytes:
            # reject BEFORE reading: an oversized body never buffers
            self._reply(413, {"error": f"body {length} bytes exceeds "
                                       f"limit {self.app.max_body_bytes}"})
            return
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("JSON body must be an object")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad JSON body: {e}"})
            return
        status, payload = self.app.handle("POST", self.path, body)
        self._reply(status, payload)

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.info("serve: %s", fmt % args)


def make_server(engine: InferenceEngine, host: str = "0.0.0.0",
                port: int = 8470, **app_kw
                ) -> Tuple[ThreadingHTTPServer, ServeApp]:
    """Build (but don't start) the HTTP server; call serve_forever() on the
    returned server, or run it on a thread (tests do)."""
    app = ServeApp(engine, **app_kw)
    handler = type("BoundHandler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    return server, app


def serve_forever(engine: InferenceEngine, host: str, port: int,
                  **app_kw) -> None:
    server, app = make_server(engine, host, port, **app_kw)
    logger.info("serving on %s:%d (devices: %s)", host, port,
                engine.stats()["devices"])
    try:
        server.serve_forever()
    finally:
        app.close()
        server.server_close()
