"""Binary logloss with a sigmoid (LightGBM's ``binary``):
grad = -y sigma / (1 + exp(y sigma s)), hess = |grad| (sigma - |grad|),
y in {-1, +1}; the start is log(p / (1 - p)) / sigma."""
from __future__ import annotations

import math

import numpy as np
import torch


class Objective:
    def __init__(self, label: np.ndarray, group, params: dict,
                 device: torch.device):
        self.sigmoid = float(params.get("sigmoid", 1.0))
        self.pos = np.asarray(label) > 0
        self.sign = torch.from_numpy(np.where(self.pos, 1.0, -1.0)).to(device)

    def init_score(self) -> float:
        p = min(max(float(self.pos.mean()), 1e-12), 1.0 - 1e-12)
        return math.log(p / (1.0 - p)) / self.sigmoid

    def gradients(self, score: torch.Tensor):
        s = self.sigmoid
        r = -self.sign * s / (1.0 + torch.exp(self.sign * s * score))
        h = r.abs() * (s - r.abs())
        return r, h, r.abs(), h
