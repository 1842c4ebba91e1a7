"""Row sampling: stateless bagging.

Port of the bagging half of ``lightgbm_tpu/boosting/sample_strategy.py``
(reference: src/boosting/bagging.hpp:26; balanced pos/neg variant at
:88-103). A strategy returns a full-length f32 in-bag indicator (0/1);
the learner multiplies the gradients by it and counts in-bag rows in the
histogram's count channel.

The draw for iteration ``i`` is stateless: ``u < frac`` with
``u = uniform(fold_in(PRNGKey(bagging_seed & 0x7FFFFFFF), i //
bagging_freq), (N,))`` under the port's threefry (``utils/prng.py``),
so the indicator equals the reference's byte for byte and needs no
sampler state. GOSS is ROADMAP item 14.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.log import unsupported
from ..utils.prng import PRNGKey, fold_in, uniform


def bag_draw(base_key: torch.Tensor, draw_idx: int, frac: torch.Tensor,
             n: int) -> torch.Tensor:
    """[n] f32 in-bag indicator for one draw index: ``u < frac`` with
    ``u ~ U[0, 1)`` under ``fold_in(base_key, draw_idx)``. ``frac`` is an
    f32 scalar (plain bagging) or an f32 [n] per-row vector (balanced
    bagging)."""
    u = uniform(fold_in(base_key, draw_idx), (n,))
    return (u < frac).to(torch.float32)


class SampleStrategy:
    """No-op default: every row in bag."""

    def __init__(self, config, num_data: int, device: torch.device):
        self.config = config
        self.num_data = num_data
        self.device = device

    def reset_metadata(self, metadata) -> None:
        pass

    def bagging(self, iter_idx: int, grad: torch.Tensor, hess: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        """Returns (grad, hess, bag); bag is None for all rows."""
        return grad, hess, None


class BaggingStrategy(SampleStrategy):
    """Random row subsampling every ``bagging_freq`` iterations; the
    indicator of iteration ``i`` depends only on ``(bagging_seed,
    i // bagging_freq)``."""

    def __init__(self, config, num_data: int, device: torch.device):
        super().__init__(config, num_data, device)
        self.freq = max(int(config.bagging_freq), 1)
        self.balanced = (config.pos_bagging_fraction < 1.0
                         or config.neg_bagging_fraction < 1.0)
        self._base_key = PRNGKey(int(config.bagging_seed) & 0x7FFFFFFF,
                                 device)
        # plain bagging: scalar fraction; balanced: per-row [N] vector
        # built at reset_metadata from the labels
        self._frac = torch.tensor(float(config.bagging_fraction),
                                  dtype=torch.float32, device=device)
        # the indicator is reused for freq iterations
        self._bag: Optional[torch.Tensor] = None
        self._bag_draw_idx = -1

    def reset_metadata(self, metadata) -> None:
        if self.balanced:
            is_pos = np.asarray(metadata.label) > 0
            frac = np.where(is_pos,
                            np.float32(self.config.pos_bagging_fraction),
                            np.float32(self.config.neg_bagging_fraction))
            self._frac = torch.from_numpy(frac.astype(np.float32)).to(
                self.device)

    def bagging(self, iter_idx, grad, hess):
        d = int(iter_idx) // self.freq
        if self._bag is None or d != self._bag_draw_idx:
            self._bag = bag_draw(self._base_key, d, self._frac,
                                 self.num_data)
            self._bag_draw_idx = d
        return grad, hess, self._bag


def create_sample_strategy(config, num_data: int, device: torch.device
                           ) -> SampleStrategy:
    """reference: SampleStrategy::CreateSampleStrategy
    (src/boosting/sample_strategy.cpp:12)."""
    if config.data_sample_strategy == "goss":
        unsupported("data_sample_strategy=goss", "item 14")
    balanced = (config.pos_bagging_fraction < 1.0
                or config.neg_bagging_fraction < 1.0)
    if ((config.bagging_fraction < 1.0 or balanced)
            and config.bagging_freq > 0):
        return BaggingStrategy(config, num_data, device)
    return SampleStrategy(config, num_data, device)
