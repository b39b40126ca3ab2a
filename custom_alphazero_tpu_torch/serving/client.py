"""Stdlib HTTP client for the serving tier.

The port's own copy of the JAX package's serving/client.py (numpy and the
standard library only), unchanged in behaviour.

Mirrors the reference's `serving/factory.py:21-119` function surface
(`infer_sample`, `get_run_id`, `append_queue`, `retrieve_queue`,
`update_best_model`, `get_queue_size`) over urllib instead of `requests`,
including its graceful-degradation contracts: inference decode failure
returns a zero policy + value 0 (factory.py:46-55), queue/run-id failures
return None (factory.py:62-66, 90-93).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional, Tuple

import numpy as np


class ServingClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5555,
                 timeout: float = 10.0):
        self.base = f"http://{host}:{port}/api"
        self.timeout = timeout

    def _call(self, path: str, payload=None, method: str = "POST"):
        url = f"{self.base}/{path}"
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def get_run_id(self) -> Optional[str]:
        try:
            return self._call("run-id", method="GET")["run_id"]
        except (urllib.error.URLError, KeyError, json.JSONDecodeError,
                TimeoutError):
            return None  # factory.py:62-66

    def infer_sample(self, state: np.ndarray,
                     num_actions: Optional[int] = None
                     ) -> Tuple[np.ndarray, float]:
        try:
            out = self._call("inference", {"state": np.asarray(state).tolist()})
            return np.asarray(out["probabilities"], np.float32), float(
                out["values"]
            )
        except (urllib.error.URLError, KeyError, json.JSONDecodeError,
                TimeoutError):
            # Zero-policy fallback (factory.py:46-55).
            n = num_actions or 0
            return np.zeros((n,), np.float32), 0.0

    def append_queue(self, states, policies, values) -> Optional[int]:
        try:
            return self._call(
                "queue/append",
                {
                    "states": np.asarray(states).tolist(),
                    "policies": np.asarray(policies).tolist(),
                    "values": np.asarray(values).tolist(),
                },
            )["appended"]
        except (urllib.error.URLError, KeyError, json.JSONDecodeError,
                TimeoutError):
            return None

    def retrieve_queue(self):
        try:
            out = self._call("queue/retrieve")
            return (
                np.asarray(out["states"], np.float32),
                np.asarray(out["policies"], np.float32),
                np.asarray(out["values"], np.float32),
            )
        except (urllib.error.URLError, KeyError, json.JSONDecodeError,
                TimeoutError, ValueError):
            return None  # factory.py:90-93

    def update_best_model(self) -> bool:
        try:
            return bool(self._call("best-model/update")["updated"])
        except (urllib.error.URLError, KeyError, json.JSONDecodeError,
                TimeoutError):
            return False

    def get_queue_size(self) -> Optional[int]:
        try:
            return self._call("queue/size", method="GET")["queue_size"]
        except (urllib.error.URLError, KeyError, json.JSONDecodeError,
                TimeoutError):
            return None
