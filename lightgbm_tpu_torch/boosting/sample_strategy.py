"""Row sampling: stateless bagging and GOSS.

Port of ``lightgbm_tpu/boosting/sample_strategy.py`` (reference:
src/boosting/bagging.hpp:26, balanced pos/neg variant at :88-103;
src/boosting/goss.hpp:30). A strategy returns a full-length f32 in-bag
indicator (0/1), and GOSS its rescaled gradients; the learner multiplies
the gradients by the indicator and counts in-bag rows in the histogram's
count channel.

Every draw is stateless: ``u = uniform(fold_in(PRNGKey(bagging_seed &
0x7FFFFFFF), d), (N,))`` under the port's threefry (``utils/prng.py``),
with ``d = i // bagging_freq`` for bagging and ``d = i`` for GOSS at
iteration ``i``, so the indicator equals the reference's byte for byte
and needs no sampler state. Every draw runs on the gradients' device
with no host read, so the batched loop (``GBDT.train_batch``) takes it
as it is through :meth:`SampleStrategy.device_draw`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import log
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

    def refresh_config(self, config) -> None:
        """Re-read the config after ``reset_parameter``; the default
        strategy keeps nothing from it."""
        self.config = config

    def bagging(self, iter_idx: int, grad: torch.Tensor, hess: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        """Returns (grad, hess, bag); bag is None for all rows."""
        return grad, hess, None

    def supports_device_draw(self) -> bool:
        """True when :meth:`device_draw` gives :meth:`bagging`'s draw from
        the iteration index alone, on the device (reference
        ``supports_device_draw``): the eligibility bit
        ``GBDT.can_train_batched`` reads. A subclass that overrides
        ``bagging`` without a ``device_draw`` at the same level or below
        declines: the inherited draw would replace its sampling in the
        batched loop."""
        cls = type(self)

        def defining(name):
            for c in cls.__mro__:
                if name in c.__dict__:
                    return c
            return SampleStrategy

        return issubclass(defining("device_draw"), defining("bagging"))

    def device_draw(self, iter_idx: int, grad: torch.Tensor,
                    hess: torch.Tensor):
        """The batched loop's draw at iteration ``iter_idx`` (the
        reference's ``apply_traced``); the same (grad, hess, bag) as
        :meth:`bagging`."""
        return grad, hess, None


def goss_threshold(w: torch.Tensor, top_k: int) -> torch.Tensor:
    """The ``top_k``-th largest value of ``w`` (0-d, on ``w``'s device):
    the reference's ``jax.lax.top_k(w, top_k)[0][-1]``. Only the value
    counts (rows equal to it are all top rows, in whatever order top-k
    returns them). ``torch.topk`` finds it faster than
    ``torch.kthvalue`` (the same value) at top_k = 2.1M of 10.5M rows on
    an H100; ``chip_smoke.py`` phase 14b times both (PERF.md §6)."""
    return torch.topk(w, top_k).values[-1]


def goss_draw(grad: torch.Tensor, hess: torch.Tensor, base_key: torch.Tensor,
              iter_idx: int, top_k: int, other_k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One GOSS draw (reference ``GOSSStrategy._goss``,
    lightgbm_tpu/boosting/sample_strategy.py:244): keep the rows whose
    ``w = sum_k |g_k * h_k|`` reaches the ``top_k``-th largest, sample
    each other row with probability ``other_k / (n - top_k)`` and scale
    a sampled row's gradient and hessian by ``(n - top_k) / other_k``.
    ``grad`` and ``hess`` are f32 [N] or [N, K]. Returns (scaled grad,
    scaled hess, f32 [N] in-bag indicator).

    The rounding is the reference's, bit for bit: ``w`` sums the class
    columns left to right (XLA's reduce order over a row); the
    probability is an f32 quotient of f32 operands (JAX divides a
    Python int by an int32 array in f32) and ``u < prob`` compares f32
    with f32; the scale is the float64 quotient rounded once to f32 (a
    Python float meeting an f32 array)."""
    g2 = torch.abs(grad * hess)
    if g2.dim() == 1:
        w = g2
    else:
        w = g2[:, 0]
        for k in range(1, g2.shape[1]):
            w = w + g2[:, k]
    n = w.shape[0]
    is_top = w >= goss_threshold(w, top_k)
    prob = float(np.float32(other_k) / np.float32(max(n - top_k, 1)))
    u = uniform(fold_in(base_key, int(iter_idx)), (n,))
    sampled = ~is_top & (u < prob)
    bag = (is_top | sampled).to(torch.float32)
    multiply = float(np.float32((n - top_k) / other_k))
    scale = torch.where(sampled, multiply, 1.0)
    if grad.dim() > 1:
        scale = scale[:, None]
    return grad * scale, hess * scale, bag


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
            self._is_pos = np.asarray(metadata.label) > 0
            self._frac = self._balanced_frac()

    def _balanced_frac(self) -> torch.Tensor:
        frac = np.where(self._is_pos,
                        np.float32(self.config.pos_bagging_fraction),
                        np.float32(self.config.neg_bagging_fraction))
        return torch.from_numpy(frac.astype(np.float32)).to(self.device)

    def refresh_config(self, config) -> None:
        """A bagging fraction or frequency set by ``reset_parameter``
        takes effect at the next draw (reference:
        ``BaggingStrategy.refresh_config``); the current bag stays."""
        self.config = config
        self.freq = max(int(config.bagging_freq), 1)
        if self.balanced:
            self._frac = self._balanced_frac()
        else:
            self._frac = torch.tensor(float(config.bagging_fraction),
                                      dtype=torch.float32,
                                      device=self.device)

    def bagging(self, iter_idx, grad, hess):
        d = int(iter_idx) // self.freq
        if self._bag is None or d != self._bag_draw_idx:
            self._bag = bag_draw(self._base_key, d, self._frac,
                                 self.num_data)
            self._bag_draw_idx = d
        return grad, hess, self._bag

    # the draw keys on the iteration index only and makes no host read
    device_draw = bagging


class GOSSStrategy(SampleStrategy):
    """Gradient-based one-side sampling (reference ``GOSSStrategy``;
    upstream goss.hpp:30-165): :func:`goss_draw` every iteration from
    ``int(1 / learning_rate)`` on, every row in bag before (the warm-up,
    goss.hpp:33). ``top_k = max(1, int(N * top_rate))`` and ``other_k =
    max(1, int(N * other_rate))``."""

    def __init__(self, config, num_data: int, device: torch.device):
        super().__init__(config, num_data, device)
        if config.top_rate + config.other_rate > 1.0:
            log.fatal("top_rate + other_rate must be <= 1.0 for GOSS")
        if config.top_rate <= 0.0 or config.other_rate <= 0.0:
            log.fatal("top_rate and other_rate must be positive for GOSS")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
        log.info("Using GOSS")
        self._base_key = PRNGKey(int(config.bagging_seed) & 0x7FFFFFFF,
                                 device)
        self.top_k = max(1, int(num_data * config.top_rate))
        self.other_k = max(1, int(num_data * config.other_rate))
        self.refresh_config(config)

    def refresh_config(self, config) -> None:
        """Re-read the learning rate (the warm-up reads it live, as the
        reference's ``refresh_config`` does). ``top_rate`` and
        ``other_rate`` keep the values of the construction, as in the
        reference (upstream's ``GOSSStrategy::ResetSampleConfig`` would
        take new ones)."""
        self.config = config
        self.warmup = int(1.0 / max(config.learning_rate, 1e-12))

    def bagging(self, iter_idx, grad, hess):
        if iter_idx < self.warmup:
            return grad, hess, None
        return goss_draw(grad, hess, self._base_key, iter_idx, self.top_k,
                         self.other_k)

    device_draw = bagging


def create_sample_strategy(config, num_data: int, device: torch.device
                           ) -> SampleStrategy:
    """reference: SampleStrategy::CreateSampleStrategy
    (src/boosting/sample_strategy.cpp:12); ``boosting=goss`` reaches here
    as ``data_sample_strategy=goss`` (``Config._post_process``)."""
    if config.data_sample_strategy == "goss":
        return GOSSStrategy(config, num_data, device)
    balanced = (config.pos_bagging_fraction < 1.0
                or config.neg_bagging_fraction < 1.0)
    if ((config.bagging_fraction < 1.0 or balanced)
            and config.bagging_freq > 0):
        return BaggingStrategy(config, num_data, device)
    return SampleStrategy(config, num_data, device)
