"""Serving daemon: a JSON-over-HTTP front end for ``Recommender``.

The JAX package's ``server.py`` on the port: load (or receive) a model once,
keep the full-catalog score matrix resident on the device, and answer top-K /
scoring queries over HTTP. The ``Recommender`` hands back NumPy, so the
routing is the JAX daemon's, line for line.

Stdlib-only (``http.server``). Device work is serialised behind a lock.

Endpoints:
  GET  /healthz                       -> {"status": "ok", ...}
  GET  /v1/recommend?user=12&k=10     -> {"user": 12, "items": [...], "scores": [...]}
  POST /v1/recommend {"users": [..], "k": 10}
                                      -> {"items": [[...], ...], "scores": [[...], ...]}
  POST /v1/score     {"user": 3, "items": [..]}
                                      -> {"scores": [...]}
  POST /v1/refresh                    -> rescore catalog (after a params swap)
  GET  /v1/stats                      -> request counters + latency summary
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearningrecommendationsystem_tpu_torch.serving import Recommender


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.latencies_ms: list = []

    def record(self, ms: float, error: bool = False) -> None:
        with self.lock:
            self.requests += 1
            self.errors += int(error)
            self.latencies_ms.append(ms)
            if len(self.latencies_ms) > 10000:
                self.latencies_ms = self.latencies_ms[-5000:]

    def summary(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies_ms)
            out = {"requests": self.requests, "errors": self.errors}
            if lat:
                out["latency_ms"] = {
                    "p50": lat[len(lat) // 2],
                    "p99": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
                    "max": lat[-1],
                }
            return out


class RecommenderServer:
    """Owns a ``Recommender`` and serves it over HTTP until ``shutdown()``."""

    def __init__(self, recommender: Recommender, host: str = "127.0.0.1", port: int = 0):
        self.recommender = recommender
        self.device_lock = threading.Lock()
        self.stats = _Stats()
        with self.device_lock:
            recommender.refresh()  # materialise scores before accepting traffic
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _handle(self, method: str) -> None:
                t0 = time.perf_counter()
                error = False
                try:
                    code, payload = server.dispatch(method, self.path, self._body())
                    error = code >= 400
                except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
                    code, payload = 500, {"error": repr(e)}
                    error = True
                self._reply(code, payload)
                server.stats.record((time.perf_counter() - t0) * 1e3, error)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                if not n:
                    return {}
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ---- request routing (pure function of method/path/body, easy to test)

    def dispatch(self, method: str, path: str, body: dict):
        parsed = urlparse(path)
        route = (method, parsed.path)
        if route == ("GET", "/healthz"):
            num_users, num_items = self.recommender.shape
            return 200, {"status": "ok", "num_users": num_users, "num_items": num_items}
        if route == ("GET", "/v1/recommend"):
            q = parse_qs(parsed.query)
            try:
                user = int(q["user"][0])
            except (KeyError, ValueError):
                return 400, {"error": "missing/invalid ?user="}
            k = int(q.get("k", ["10"])[0])
            items, scores = self._topk([user], k)
            return 200, {"user": user, "items": items[0], "scores": scores[0]}
        if route == ("POST", "/v1/recommend"):
            users = body.get("users")
            if not isinstance(users, list) or not users:
                return 400, {"error": "body must contain non-empty 'users' list"}
            k = int(body.get("k", 10))
            items, scores = self._topk([int(u) for u in users], k)
            return 200, {"items": items, "scores": scores}
        if route == ("POST", "/v1/score"):
            try:
                user = int(body["user"])
                items = [int(i) for i in body["items"]]
            except (KeyError, TypeError, ValueError):
                return 400, {"error": "body must contain 'user' and 'items'"}
            with self.device_lock:
                scores = self.recommender.score(user, items)
            return 200, {"scores": np.asarray(scores).tolist()}
        if route == ("POST", "/v1/refresh"):
            with self.device_lock:
                self.recommender.refresh()
            return 200, {"status": "refreshed"}
        if route == ("GET", "/v1/stats"):
            return 200, self.stats.summary()
        return 404, {"error": f"no route {method} {parsed.path}"}

    def _topk(self, users, k):
        num_users, num_items = self.recommender.shape
        for u in users:
            if not 0 <= u < num_users:
                raise ValueError(f"user {u} out of range [0, {num_users})")
        k = max(1, min(k, num_items))
        with self.device_lock:
            idx, scores = self.recommender.top_k_with_scores(k, users)
        return idx.tolist(), np.asarray(scores).tolist()

    # ---- lifecycle

    def serve_background(self) -> "RecommenderServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
