"""HTTP serving tier for external clients (the port of serving/).

A process that answers run-id handshakes, accepts and drains sample
batches, reloads the best model on demand and serves micro-batched
policy-value inference over HTTP; ``python -m
custom_alphazero_tpu_torch.serving`` runs it with the port's net on the
card. The server and client are the port's own copies of the JAX
package's, standard library and numpy only.
"""

from custom_alphazero_tpu_torch.serving.client import ServingClient
from custom_alphazero_tpu_torch.serving.server import (
    InferenceService,
    MicroBatcher,
)

__all__ = ["InferenceService", "MicroBatcher", "ServingClient"]
