"""Binary classification objective.

Port of ``lightgbm_tpu/objective/binary.py`` (reference:
src/objective/binary_objective.hpp:21).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction, apply_weight

_EPS = 1e-12


class BinaryLogloss(ObjectiveFunction):
    """Sigmoid-scaled logloss (reference: binary_objective.hpp:105-135):

        response = -label * sigmoid / (1 + exp(label * sigmoid * score))
        grad = response * label_weight
        hess = |response| * (sigmoid - |response|) * label_weight

    with label in {-1, +1} and label weights from is_unbalance /
    scale_pos_weight (Init, :59-102). ``is_pos`` maps raw labels to the
    positive class (``y > 0`` by default)."""

    name = "binary"

    def __init__(self, config, is_pos=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log.fatal("Sigmoid parameter %f should be greater than zero"
                      % self.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")
        # which labels count as positive: ``y > 0``, or one class of a
        # one-vs-all multiclass objective
        self._is_pos = is_pos if is_pos is not None else (lambda y: y > 0)
        self.need_train = True

    def init(self, metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        super().init(metadata, num_data, device)
        is_pos = self._is_pos(np.asarray(metadata.label))
        cnt_positive = int(is_pos.sum())
        cnt_negative = num_data - cnt_positive
        self.need_train = True
        if cnt_negative == 0 or cnt_positive == 0:
            log.warning("Contains only one class")
            self.need_train = False
        log.info("Number of positive: %d, number of negative: %d"
                 % (cnt_positive, cnt_negative))
        pos_weight, neg_weight = 1.0, 1.0
        if self.is_unbalance and cnt_positive > 0 and cnt_negative > 0:
            if cnt_positive > cnt_negative:
                neg_weight = cnt_positive / cnt_negative
            else:
                pos_weight = cnt_negative / cnt_positive
        pos_weight *= self.scale_pos_weight
        self.label_sign = torch.from_numpy(
            np.where(is_pos, 1.0, -1.0).astype(np.float32)).to(device)
        self.label_weight = torch.from_numpy(
            np.where(is_pos, pos_weight, neg_weight).astype(np.float32)
        ).to(device)
        self._is_pos_np = is_pos
        self._weights_np = (None if metadata.weights is None else
                            np.asarray(metadata.weights, dtype=np.float32))

    def get_gradients(self, score: torch.Tensor):
        if not self.need_train:
            z = torch.zeros_like(score)
            return z, z
        # a fill on the device: a tensor from a host value is a copy
        # that waits for the card
        sig = torch.full((), self.sigmoid, dtype=torch.float32,
                         device=score.device)
        response = (-self.label_sign * sig
                    / (1.0 + torch.exp(self.label_sign * sig * score)))
        abs_r = response.abs()
        grad = response * self.label_weight
        hess = abs_r * (sig - abs_r) * self.label_weight
        return apply_weight(grad, hess, self.weights)

    def boost_from_score(self, class_id: int = 0) -> float:
        is_pos = self._is_pos_np.astype(np.float64)
        if self._weights_np is not None:
            w = self._weights_np.astype(np.float64)
            pavg = (is_pos * w).sum() / w.sum()
        else:
            pavg = is_pos.mean()
        pavg = min(max(pavg, _EPS), 1.0 - _EPS)
        initscore = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f"
                 % (self.name, pavg, initscore))
        return initscore

    def class_need_train(self, class_id: int) -> bool:
        return self.need_train

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))

    def to_string(self) -> str:
        return "%s sigmoid:%g" % (self.name, self.sigmoid)
