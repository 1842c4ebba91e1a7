"""Higgs-shaped rows (UCI HIGGS: 28 dense features, binary label):
standard normal columns, every fourth heavy-tailed (|x|^1.5), and a
label from a noisy linear-plus-interaction logit. The relevance weights
are fixed (``relevance_seed``); the rows and the noise follow the seed.
The pattern is the reference bench's ``make_higgs_like``."""
from __future__ import annotations

import numpy as np
import torch

from . import torch_generator


def _rows(n: int, F: int, w: torch.Tensor, g, device) -> tuple:
    X = torch.randn((n, F), generator=g, device=device)
    X[:, ::4] = X[:, ::4].abs() ** 1.5
    logit = (X * w).sum(dim=1) + 0.5 * torch.sin(X[:, 0]) * X[:, 1]
    noise = torch.randn(n, generator=g, device=device) * 0.5
    y = (logit + noise > 0).double()
    return X, y


def make(spec: dict, seed: int, device: torch.device) -> dict:
    F = int(spec["features"])
    w = torch.from_numpy((np.random.RandomState(int(spec["relevance_seed"]))
                          .randn(F) * 0.6).astype(np.float32)).to(device)
    out = {}
    for part, stream in (("train", 0), ("held_out", 1)):
        n = int(spec[part + "_rows"])
        if n == 0:
            continue
        X, y = _rows(n, F, w, torch_generator(seed, stream, device), device)
        out[part] = {"X": X.cpu().numpy(), "label": y.cpu().numpy(),
                     "group": None}
        del X, y
    return out
