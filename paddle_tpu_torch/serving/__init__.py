"""Serving of the port: saved-model inference (``ServingEngine`` over
captured programs, the ``MicroBatcher``, ``ExecutableCache``) and
generation (KV block pool, continuous decode batching, the slot-bank
engine), behind one wire server/client."""
from .batching import (PRIORITIES, BadRequestError, DeadlineExceededError,
                       DecodeBatcher, GenerationRequest, InternalServerError,
                       MicroBatcher, Request, RequestQueue,
                       ServerOverloadedError, ServerShutdownError,
                       ServingError, next_bucket, priority_rank)
from .cache import ExecutableCache, feed_signature
from .engine import GenerationEngine, ServingEngine
from .kvpool import KVBlockPool, KVPoolExhaustedError
from .metrics import LatencyHistogram, ServingStats
from .server import Client, InferenceServer, ServingConfig

__all__ = ["BadRequestError", "Client", "DeadlineExceededError",
           "DecodeBatcher", "ExecutableCache", "GenerationEngine",
           "GenerationRequest", "InferenceServer", "InternalServerError",
           "KVBlockPool", "KVPoolExhaustedError", "LatencyHistogram",
           "MicroBatcher", "PRIORITIES", "Request", "RequestQueue",
           "ServerOverloadedError", "ServerShutdownError", "ServingConfig",
           "ServingEngine", "ServingError", "ServingStats",
           "feed_signature", "next_bucket", "priority_rank"]
