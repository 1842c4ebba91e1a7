"""Objective function interface.

Port of ``lightgbm_tpu/objective/base.py`` (reference:
include/LightGBM/objective_function.h:19). ``init(metadata, num_data,
device)`` puts label and weight tensors on the learner's device;
``get_gradients(score)`` returns f32 ``(grad, hess)`` tensors shaped
like ``score``, computed elementwise on that device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class ObjectiveFunction:
    #: model-format name (reference: each objective's ToString())
    name: str = "custom"

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.device = torch.device("cpu")
        self.label: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        """Bind training metadata (reference: ObjectiveFunction::Init).
        Labels and weights are f32, as in the reference's device
        arrays."""
        self.num_data = num_data
        self.device = device
        self.label = torch.from_numpy(
            np.asarray(metadata.label, dtype=np.float32)).to(device)
        self.weights = None if metadata.weights is None else \
            torch.from_numpy(np.asarray(metadata.weights,
                                        dtype=np.float32)).to(device)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def boost_from_score(self, class_id: int = 0) -> float:
        """Optimal constant initial score (used when boost_from_average)."""
        return 0.0

    def class_need_train(self, class_id: int) -> bool:
        return True

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        """Raw score -> prediction output (host)."""
        return score

    def to_string(self) -> str:
        return self.name

    def __str__(self) -> str:
        return self.to_string()
