"""Serving of the port: saved-model inference (``ServingEngine`` over
captured programs, the ``MicroBatcher``, ``ExecutableCache``) and
generation (KV block pool, continuous decode batching, the slot-bank
engine), behind one wire server/client, with the resilience layer:
supervised loops (``LoopSupervisor``), the ``BrownoutController``
ladder, hot weight reload (``load_param_snapshot``, ``SwapHandle``),
drain, cancel (``RequestCancelledError``), request dedup and client
hedging; and tensor-parallel generation behind all of it (``serving.tp``:
a leader rank that hands every engine call to its followers)."""
from .batching import (PRIORITIES, BadRequestError, DeadlineExceededError,
                       DecodeBatcher, GenerationRequest, InternalServerError,
                       MicroBatcher, Request, RequestCancelledError,
                       RequestQueue, ServerOverloadedError,
                       ServerShutdownError, ServingError, SwapHandle,
                       next_bucket, priority_rank, remaining_budget_ms)
from .brownout import BrownoutController
from .cache import ExecutableCache, feed_signature
from .engine import (SIGNATURE_FILE, GenerationEngine, ServingEngine,
                     load_param_snapshot)
from .kvpool import KVBlockPool, KVPoolExhaustedError
from .metrics import LatencyHistogram, ServingStats
from .server import (CheckpointCorruptReply, Client, InferenceServer,
                     ServingConfig, WatchdogError)
from .supervise import LoopSupervisor
from .tp import (TPDivergedError, TPFollower, TPGroupLostError,
                 TPLeaderEngine, check_serving_world, tp_generation_engine)

__all__ = ["BadRequestError", "BrownoutController", "CheckpointCorruptReply",
           "Client",
           "DeadlineExceededError", "DecodeBatcher", "ExecutableCache",
           "GenerationEngine", "GenerationRequest", "InferenceServer",
           "InternalServerError", "KVBlockPool", "KVPoolExhaustedError",
           "LatencyHistogram", "LoopSupervisor", "MicroBatcher",
           "PRIORITIES", "Request", "RequestCancelledError", "RequestQueue",
           "SIGNATURE_FILE", "ServerOverloadedError", "ServerShutdownError",
           "ServingConfig", "ServingEngine", "ServingError", "ServingStats",
           "SwapHandle", "TPDivergedError", "TPFollower",
           "TPGroupLostError", "TPLeaderEngine", "WatchdogError",
           "check_serving_world", "feed_signature",
           "load_param_snapshot", "next_bucket", "priority_rank",
           "remaining_budget_ms", "tp_generation_engine"]
