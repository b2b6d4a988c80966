"""Generation serving of the port: KV block pool, continuous decode
batching, the slot-bank engine and the wire server/client."""
from .batching import (BadRequestError, DeadlineExceededError,
                       DecodeBatcher, GenerationRequest, InternalServerError,
                       RequestQueue, ServerOverloadedError,
                       ServerShutdownError, ServingError, next_bucket)
from .engine import GenerationEngine
from .kvpool import KVBlockPool, KVPoolExhaustedError
from .metrics import LatencyHistogram, ServingStats
from .server import Client, InferenceServer

__all__ = ["BadRequestError", "Client", "DeadlineExceededError",
           "DecodeBatcher", "GenerationEngine", "GenerationRequest",
           "InferenceServer", "InternalServerError", "KVBlockPool",
           "KVPoolExhaustedError", "LatencyHistogram", "RequestQueue",
           "ServerOverloadedError", "ServerShutdownError", "ServingError",
           "ServingStats", "next_bucket"]
