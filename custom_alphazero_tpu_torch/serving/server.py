"""Stdlib HTTP serving process: run-id, sample queue, best-model, inference.

The port's own copy of the JAX package's serving/server.py (numpy and the
standard library only): the same endpoints, JSON shapes, verbs and
micro-batching. One difference: the server listens with a backlog of 128
connections where JAX's keeps socketserver's 5, under which 32 clients
connecting at once saw one-second connect retries and resets.

Re-designs the reference's FastAPI serving app (serving/api/main.py:21-51 and
the four routers under serving/api/) as one dependency-free
ThreadingHTTPServer. Endpoint surface and JSON shapes mirror the reference
(serving/schemas/schemas.py:6-34, ConfigPath endpoints config.py:96-105):

    GET  /api/run-id              -> {"run_id": str}
    POST /api/queue/append        {"states","policies","values"} -> {"appended": n}
    POST /api/queue/retrieve      -> {"states","policies","values"} (drain-all)
    GET  /api/queue/size          -> {"queue_size": n}
    POST /api/best-model/update   -> {"updated": bool} (reload via callback)
    POST /api/inference           {"state": [...]} or {"states": [[...]]}
                                  -> {"probabilities": [...], "values": v}

(The reference used PATCH/PUT verbs for queue/best-model; those are accepted
as aliases.)

Cross-request inference micro-batching reproduces `InferenceBatch`
(serving/inference_batch.py:9-66) on threads instead of asyncio: requests
park on a condition variable until `batch_size` states accumulate or
`timeout` elapses, then one thread runs a single batched forward and all
waiters collect their row — the HTTP-era ancestor of the in-search batched
leaf evaluation.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

import numpy as np

EvaluateFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


class _Server(ThreadingHTTPServer):
    request_queue_size = 128  # pending connections (socketserver: 5)


class MicroBatcher:
    """Thread-based cross-request batcher (reference InferenceBatch,
    serving/inference_batch.py:28-63)."""

    def __init__(self, evaluate: EvaluateFn, batch_size: int,
                 timeout: float = 0.05):
        self._evaluate = evaluate
        self.batch_size = max(1, batch_size)
        self.timeout = timeout
        self._cv = threading.Condition()
        self._pending = {}     # uid -> state
        self._results = {}     # uid -> (probs, value)
        self._generation = 0

    def update_model(self, evaluate: EvaluateFn) -> None:
        """Swap the model between batches (reference :65-66)."""
        with self._cv:
            self._evaluate = evaluate

    def infer(self, state: np.ndarray):
        """Park until a batch forms (or timeout), run/collect one forward."""
        uid = object()
        with self._cv:
            self._pending[uid] = state
            if len(self._pending) >= self.batch_size:
                self._flush_locked()
            deadline = time.monotonic() + self.timeout
            while uid not in self._results:
                if uid in self._pending:
                    # Not yet claimed by any flush.
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # Timed out as batch leader: flush whatever queued.
                        self._flush_locked()
                        break
                    self._cv.wait(remaining)
                else:
                    # Claimed by an in-flight flush: a result (or error) is
                    # guaranteed to be posted when its forward finishes.
                    self._cv.wait(1.0)
            result = self._results.pop(uid)
            if isinstance(result, BaseException):
                raise result
            return result

    def _flush_locked(self) -> None:
        # Claim the batch under the lock, but run the model forward with the
        # lock RELEASED so new requests keep accumulating into the next
        # batch during evaluation (the reference batcher accumulates during
        # its awaited forward the same way, inference_batch.py:35-54).
        batch = self._pending
        if not batch:
            return
        self._pending = {}
        self._generation += 1
        evaluate = self._evaluate
        error = None
        self._cv.release()
        try:
            states = np.stack(
                [np.asarray(s, np.float32) for s in batch.values()]
            )
            probs, values = evaluate(states)
            probs = np.asarray(probs)
            values = np.asarray(values).reshape(-1)
        except BaseException as exc:  # posted to every waiter below
            error = exc
        finally:
            self._cv.acquire()
        for i, uid in enumerate(batch.keys()):
            self._results[uid] = (
                error if error is not None else (probs[i], float(values[i]))
            )
        self._cv.notify_all()


class InferenceService:
    """The serving process state + HTTP server (reference
    serving/api/main.py:21-45: run_id, queue, best model, micro-batcher)."""

    def __init__(
        self,
        evaluate: EvaluateFn,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        queue_capacity: int = 100_000,
        inference_batch_size: int = 1,
        inference_timeout: float = 0.05,
        reload_model: Optional[Callable[[], EvaluateFn]] = None,
        run_id: Optional[str] = None,
    ):
        # Run identity is born here (main.py:24).
        self.run_id = run_id or datetime.now().strftime("%Y-%m-%d-%H%M%S")
        self._queue = deque(maxlen=queue_capacity)
        self._queue_lock = threading.Lock()
        self._reload_model = reload_model
        self.batcher = MicroBatcher(
            evaluate, inference_batch_size, inference_timeout
        )
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _reply(self, payload, status=200):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                length = int(self.headers.get("Content-Length", 0))
                if not length:
                    return {}
                return json.loads(self.rfile.read(length))

            def do_GET(self):
                if self.path == "/api/run-id":
                    self._reply({"run_id": service.run_id})
                elif self.path == "/api/queue/size":
                    self._reply({"queue_size": service.queue_size()})
                else:
                    self._reply({"error": "not found"}, 404)

            def do_POST(self):
                try:
                    if self.path == "/api/queue/append":
                        data = self._body()
                        n = service.append(
                            data["states"], data["policies"], data["values"]
                        )
                        self._reply({"appended": n})
                    elif self.path == "/api/queue/retrieve":
                        states, policies, values = service.retrieve()
                        self._reply({
                            "states": states,
                            "policies": policies,
                            "values": values,
                        })
                    elif self.path == "/api/best-model/update":
                        self._reply({"updated": service.update_best_model()})
                    elif self.path == "/api/inference":
                        data = self._body()
                        state = data.get("state")
                        if state is not None:
                            probs, value = service.batcher.infer(
                                np.asarray(state, np.float32)
                            )
                            self._reply({
                                "probabilities": probs.tolist(),
                                "values": value,
                            })
                        else:
                            states = np.asarray(
                                data["states"], np.float32
                            )
                            probs, values = service.batcher._evaluate(states)
                            self._reply({
                                "probabilities": np.asarray(probs).tolist(),
                                "values": np.asarray(values)
                                .reshape(-1)
                                .tolist(),
                            })
                    else:
                        self._reply({"error": "not found"}, 404)
                except Exception as exc:  # noqa: BLE001 — report to client
                    self._reply({"error": repr(exc)}, 500)

            # Reference verbs (factory.py:73, :87, :105) as aliases.
            do_PATCH = do_POST
            do_PUT = do_POST

        self._httpd = _Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- queue (reference serving/api/queue.py:13-44) -----------------------

    def append(self, states, policies, values) -> int:
        with self._queue_lock:
            n = 0
            for item in zip(states, policies, values):
                self._queue.append(item)
                n += 1
        return n

    def retrieve(self):
        """Drain-all (reference queue.py:25-39)."""
        with self._queue_lock:
            items = list(self._queue)
            self._queue.clear()
        states = [s for s, _, _ in items]
        policies = [p for _, p, _ in items]
        values = [v for _, _, v in items]
        return states, policies, values

    def queue_size(self) -> int:
        with self._queue_lock:
            return len(self._queue)

    # -- best model (reference serving/api/best_model.py:8-10) --------------

    def update_best_model(self) -> bool:
        if self._reload_model is None:
            return False
        self.batcher.update_model(self._reload_model())
        return True

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "InferenceService":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
