"""Batched inference: StackedForest, the row-bucketed predictor, and
the micro-batching PredictServer with its model registry.

Port of ``lightgbm_tpu/serve``. The training pipeline predicts one tree
at a time; serving batches the FOREST: one device pass quantizes raw
float rows against the model's own thresholds and walks all T trees.
The server is overload-safe by construction: a bounded queue with
reject/block shedding, per-request deadline budgets, a circuit breaker
over dispatch failures, canary model swaps with automatic rollback, and
a graceful drain that never strands a Future (``docs/SERVING.md`` has
the semantics and the typed error catalog).

>>> from lightgbm_tpu_torch.serve import PredictServer, StackedForest
>>> forest = StackedForest.from_gbdt(booster)     # or a Booster directly
>>> server = PredictServer(forest, max_batch=256, max_queue_rows=4096,
...                        replicas="auto")       # one replica per card
>>> server.predict(row, deadline_ms=50)           # coalesced micro-batch

``replicas="auto"`` places the forest on every visible card and runs
one dispatch worker per replica over one admission queue: admission
control, deadlines, the breaker and canary rollback stay global.
``devices=["cpu"]`` serves on the CPU.
"""
from .cache import BucketedPredictor
from .forest import StackedForest, round_down_f32
from .replicate import ReplicatedForest, sharded_bucket
from .server import (BreakerOpen, CircuitBreaker, DeadlineExceeded,
                     ModelRegistry, Overloaded, PredictServer, ServeError,
                     ShuttingDown)

__all__ = ["StackedForest", "BucketedPredictor", "ModelRegistry",
           "PredictServer", "round_down_f32", "ServeError", "Overloaded",
           "DeadlineExceeded", "ShuttingDown", "BreakerOpen",
           "CircuitBreaker", "ReplicatedForest", "sharded_bucket"]
