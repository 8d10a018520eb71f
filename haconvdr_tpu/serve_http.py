"""HTTP/JSON serving daemon over the micro-batching retrieval frontend.

The reference exposes retrieval only as offline batch-eval scripts
(/root/reference/src/test_HAConvDR_topiocqa.py); `serve.Retriever` made it
a reusable object and `serve.BatchingRetriever` a coalescing frontend —
this module is the network face: a stdlib-only (zero new dependencies)
threaded HTTP server whose request threads block on the batcher's
futures, so CONCURRENT HTTP CLIENTS ARE WHAT FORMS THE DEVICE BATCHES.
One device dispatch stream (the batcher's worker thread) serves any number
of connections.

API (all JSON):

  POST /retrieve        {"question": str, "history": [[q, a], ...],
                         "history_passages": [str, ...], "k": int}
                        -> {"hits": [{"pid": int, "score": float}, ...],
                            "latency_ms": float}
  POST /retrieve_batch  {"queries": [<retrieve body>, ...]}
                        -> {"results": [<retrieve response>, ...]}
                        (submitted together -> coalesced into one dispatch)
  GET  /healthz         {"ok": true, "uptime_s": float}

Backpressure: the batcher queue is bounded (``queue_depth``) — submits
beyond it get 503 + a ``Retry-After`` header instead of queueing
unboundedly; every accepted request is answered within
``request_timeout_s`` (504 on a stalled device dispatch).
  GET  /stats           batcher dispatch stats + served/error counters +
                        p50/p90/p99 request latency (ms)
  GET  /                this usage text

Run: python -m haconvdr_tpu.cli.serve serve.checkpoint_path=... \
         serve.embeddings_dir=... [serve.port=8080 serve.store_dtype=int8 ...]
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from haconvdr_tpu.serve import BacklogFull, BatchingRetriever, Retriever

logger = logging.getLogger(__name__)

_MAX_BODY = 1 << 20  # 1 MiB: a 512-token conversation is ~4 KB of JSON
_MAX_BATCH_QUERIES = 1024


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(p * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


class RetrievalServer:
    """Own the HTTP listener + the batching frontend.

    ``server = RetrievalServer(retriever); server.start()`` binds and
    serves in a daemon thread (``port=0`` picks a free port, read it back
    from ``server.port``); ``run()`` serves in the foreground until
    SIGINT.  ``close()`` stops the listener, then drains the batcher.
    """

    def __init__(
        self,
        retriever: Retriever,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        batcher: Optional[BatchingRetriever] = None,
        queue_depth: int = 1024,
        request_timeout_s: float = 30.0,
        retry_after_s: float = 1.0,
    ):
        # backpressure contract: the batcher's queue is bounded at
        # queue_depth (submit sheds with 503 + Retry-After once the
        # dispatch worker falls behind) and every accepted request is
        # answered within request_timeout_s (a stalled device dispatch
        # turns into 504s, not request threads blocked forever)
        self.request_timeout_s = float(request_timeout_s)
        self.retry_after_s = float(retry_after_s)
        self.batcher = batcher or BatchingRetriever(
            retriever, max_batch=max_batch, max_wait_ms=max_wait_ms,
            queue_depth=queue_depth,
        )
        self._t0 = time.time()
        self._lock = threading.Lock()
        self._served = 0
        self._errors = 0
        self._lat_ms: collections.deque = collections.deque(maxlen=4096)
        self._closed = False

        server = self

        class Handler(BaseHTTPRequestHandler):
            # one request thread per connection (ThreadingHTTPServer);
            # blocking on a Future here is the design — those blocked
            # threads are the concurrency the batcher coalesces
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("%s %s", self.address_string(), fmt % args)

            def _reply(
                self, code: int, obj: Dict,
                headers: Optional[Dict[str, str]] = None,
            ) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(
                        200,
                        {"ok": not server._closed,
                         "uptime_s": round(time.time() - server._t0, 3)},
                    )
                elif self.path == "/stats":
                    self._reply(200, server.stats())
                elif self.path == "/":
                    self._reply(200, {"usage": __doc__})
                else:
                    self._reply(404, {"error": f"no such path {self.path!r}"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    if length > _MAX_BODY:
                        return self._reply(413, {"error": "body too large"})
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    return self._reply(400, {"error": f"bad JSON: {e}"})
                if self.path == "/retrieve":
                    code, obj = server.handle_retrieve(payload)
                elif self.path == "/retrieve_batch":
                    code, obj = server.handle_retrieve_batch(payload)
                else:
                    code, obj = 404, {"error": f"no such path {self.path!r}"}
                headers = (
                    {"Retry-After": f"{server.retry_after_s:g}"}
                    if code == 503 else None
                )
                self._reply(code, obj, headers)

        self._http = ThreadingHTTPServer((host, port), Handler)
        self._http.daemon_threads = True
        self.host, self.port = self._http.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- request handling ------------------------------------------------
    def _submit(self, q: Dict) -> Future:
        """Validate one query dict and enqueue it; raises ValueError."""
        if not isinstance(q, dict):
            raise ValueError("query must be a JSON object")
        question = q.get("question")
        if not isinstance(question, str) or not question:
            raise ValueError('"question" (non-empty string) is required')
        history = q.get("history") or []
        if not (
            isinstance(history, list)
            and all(
                isinstance(t, (list, tuple))
                and len(t) == 2
                and all(isinstance(s, str) for s in t)
                for t in history
            )
        ):
            raise ValueError('"history" must be a list of [question, answer]')
        hp = q.get("history_passages") or []
        if not (isinstance(hp, list) and all(isinstance(s, str) for s in hp)):
            raise ValueError('"history_passages" must be a list of strings')
        k = q.get("k")
        if k is not None and not (isinstance(k, int) and k >= 1):
            raise ValueError('"k" must be a positive integer')
        return self.batcher.submit(
            question, [tuple(t) for t in history], hp, k
        )

    def _await(self, fut: Future, t0: float) -> Tuple[int, Dict]:
        try:
            hits = fut.result(timeout=self.request_timeout_s)
        except FutureTimeout:
            # a stalled device dispatch must not pin request threads
            # forever; cancel so a late dispatch skips this future (the
            # batcher claims futures via set_running_or_notify_cancel)
            fut.cancel()
            with self._lock:
                self._errors += 1
            logger.error(
                "retrieve timed out after %.1fs", self.request_timeout_s
            )
            return 504, {
                "error": f"timed out after {self.request_timeout_s:g}s"
            }
        except Exception as e:  # dispatch failure surfaced on the future
            with self._lock:
                self._errors += 1
            logger.exception("retrieve failed")
            return 500, {"error": f"{type(e).__name__}: {e}"}
        ms = (time.time() - t0) * 1e3
        with self._lock:
            self._served += 1
            self._lat_ms.append(ms)
        return 200, {
            "hits": [{"pid": p, "score": s} for p, s in hits],
            "latency_ms": round(ms, 3),
        }

    def handle_retrieve(self, payload: Dict) -> Tuple[int, Dict]:
        t0 = time.time()
        try:
            fut = self._submit(payload)
        except ValueError as e:
            return 400, {"error": str(e)}
        except BacklogFull as e:  # bounded-queue backpressure
            with self._lock:
                self._errors += 1
            return 503, {"error": str(e)}
        except RuntimeError as e:  # batcher closed
            return 503, {"error": str(e)}
        return self._await(fut, t0)

    def handle_retrieve_batch(self, payload: Dict) -> Tuple[int, Dict]:
        """Submit all queries BEFORE waiting on any: a single client's
        batch coalesces into one device dispatch exactly like concurrent
        clients would."""
        t0 = time.time()
        queries = payload.get("queries") if isinstance(payload, dict) else None
        if not isinstance(queries, list) or not queries:
            return 400, {"error": '"queries" (non-empty list) is required'}
        if len(queries) > _MAX_BATCH_QUERIES:
            return 413, {"error": f"at most {_MAX_BATCH_QUERIES} queries"}
        futs: List[Tuple[Optional[Future], Optional[str]]] = []
        for q in queries:
            try:
                futs.append((self._submit(q), None))
            except ValueError as e:
                futs.append((None, str(e)))
            except RuntimeError as e:
                futs.append((None, f"unavailable: {e}"))
        results = []
        for fut, err in futs:
            if fut is None:
                with self._lock:
                    self._errors += 1
                results.append({"error": err})
            else:
                _, obj = self._await(fut, t0)
                results.append(obj)
        return 200, {"results": results}

    # -- lifecycle ---------------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            served, errors = self._served, self._errors
        s = self.batcher.stats()
        s.update(
            served=served,
            errors=errors,
            uptime_s=round(time.time() - self._t0, 3),
            latency_ms={
                "p50": round(_percentile(lat, 0.50), 3),
                "p90": round(_percentile(lat, 0.90), 3),
                "p99": round(_percentile(lat, 0.99), 3),
                "n": len(lat),
            },
        )
        return s

    def start(self) -> "RetrievalServer":
        """Serve in a daemon thread (tests, embedding in a larger app)."""
        self._thread = threading.Thread(
            target=self._http.serve_forever, name="haconvdr-http", daemon=True
        )
        self._thread.start()
        logger.info("serving on http://%s:%d", self.host, self.port)
        return self

    def run(self) -> None:
        """Foreground serve until KeyboardInterrupt; then drain and close."""
        logger.info("serving on http://%s:%d", self.host, self.port)
        try:
            self._http.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def close(self) -> None:
        """Stop accepting, then drain in-flight work.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._http.shutdown()  # stop serve_forever (new connections refused)
        self._http.server_close()
        if self._thread is not None:
            self._thread.join()
        self.batcher.close()  # drains accepted requests (serve.py contract)

    def __enter__(self) -> "RetrievalServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
