"""Prediction through the stacked forest.

Port of the prediction core of ``lightgbm_tpu/serve``: one device pass
quantizes raw rows against the model's own thresholds and walks all T
trees (:class:`StackedForest`), behind a power-of-two row-bucket policy
(:class:`BucketedPredictor`). ``Booster.predict`` dispatches through
them. The micro-batching server, replicas and model registry are
ROADMAP item 20.

>>> from lightgbm_tpu_torch.serve import StackedForest
>>> forest = StackedForest.from_gbdt(booster).place("cuda")
>>> forest.predict(X)
"""
from .cache import BucketedPredictor
from .forest import StackedForest, round_down_f32

__all__ = ["StackedForest", "BucketedPredictor", "round_down_f32"]
