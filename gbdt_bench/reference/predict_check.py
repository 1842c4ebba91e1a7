"""The comparison that decides a prediction cell's ``correct``: the
reference walks the model text's trees over the raw rows of each checked
call, sums the leaf values in f64 in tree order and applies the
objective's output transform; ``predict_gap`` is the largest absolute
gap to the program's output of that call, ``shape_gap`` counts calls whose
output has another shape than one value per row."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from .model_text import parse_model
from .walk import StackedTrees


def output_transform(header: Dict[str, str]):
    obj = header.get("objective", "").split()
    if obj and obj[0] == "binary":
        sig = 1.0
        for tok in obj[1:]:
            if tok.startswith("sigmoid:"):
                sig = float(tok.split(":", 1)[1])
        return lambda raw: 1.0 / (1.0 + torch.exp(-sig * raw))
    raise ValueError("objective %r is outside this reference" % obj)


class PredictCheck:
    def __init__(self, model_text: str, device: torch.device,
                 dtype: torch.dtype = torch.float64):
        """``dtype`` is the precision of the sum and the transform: f64 as
        the program states; the lower-precision control passes f32."""
        model = parse_model(model_text)
        self.trees = StackedTrees(model["trees"], device)
        self.transform = output_transform(model["header"])
        self.device = device
        self.dtype = dtype

    def expected(self, X: np.ndarray) -> np.ndarray:
        Xd = torch.from_numpy(np.asarray(X)).to(self.device)
        lv = self.trees.leaf_value.to(self.dtype).gather(
            1, self.trees.leaves(Xd))
        raw = torch.zeros(Xd.shape[0], dtype=self.dtype, device=self.device)
        for t in range(self.trees.T):
            raw += lv[t]
        return self.transform(raw).double().cpu().numpy()

    def run(self, calls: Iterable[Tuple[np.ndarray, np.ndarray]]
            ) -> Dict[str, float]:
        """``calls``: (rows, the program's output) of each checked call."""
        gap, bad = 0.0, 0
        for X, out in calls:
            out = np.asarray(out)
            if out.shape != (X.shape[0],):
                bad += 1
                continue
            d = np.abs(out - self.expected(X))
            gap = max(gap, float(d.max()) if np.isfinite(d).all()
                      else float("inf"))
        return {"predict_gap": gap, "shape_gap": float(bad)}
