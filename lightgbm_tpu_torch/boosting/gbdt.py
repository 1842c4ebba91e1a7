"""GBDT boosting loop.

Port of ``lightgbm_tpu/boosting/gbdt.py`` (reference: src/boosting/
gbdt.cpp; Init at :52, TrainOneIter at :334). Gradients, tree growth and
the score update run on the learner's device; the host keeps the model
(a list of host ``Tree``s) and evaluates metrics. The training score
update gathers the new tree's leaf values over the learner's final
row->leaf partition instead of re-walking the tree (the reference's
CUDADataPartition::UpdateTrainScore trick); validation scores, rollback
and the replay of an ``init_model`` walk binned rows on the device
(``ops/predict.py``). Prediction over raw rows is the host walk here;
``Booster.predict`` sends device batches through ``serve/``.

Linear trees (``linear_tree``; reference gbdt.py:110-116,414-430,
708-716) fit each new tree's leaves on the learner's device from the
training rows' raw values, kept on the device beside the bins
(``models/linear.py``); the training and validation scores of a linear
tree come from those raw rows on the device too.

Multiclass objectives grow K trees per iteration, one per class column
of the [N, K] score (the model list is iteration-major: tree ``i * K +
k`` is class k of iteration i). Objectives with leaf renewal (l1,
quantile, mape) copy the class's score column and the row->leaf
partition to the host for it, as the reference does.

Batched iterations (``tpu_batch_iterations``; reference gbdt.py:504-700):
:meth:`GBDT.train_batch` runs T iterations through the learner's
``train_many`` with one read of their records, replays them into host
trees and defers the validation sets' tree walks to the next reader of
their scores (eval hoisting, :meth:`GBDT._flush_valid_pending`).

Telemetry (``obs/``; reference gbdt.py:96, :373-410, :493, :557-640,
:702): the stages ``gbdt::gradients``, ``gbdt::bagging``, ``tree::grow``,
``gbdt::score_update``, ``gbdt::eval_metrics``,
``tree::train_batch_dispatch`` and ``tree::apply_records``, with the
``train_iter``, ``eval``, ``train_batch`` and ``batched_eval_recheck``
events. Checkpoints (``ft/checkpoint.py``) go through
:meth:`GBDT.save_checkpoint` / :meth:`GBDT.load_checkpoint`.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..io.dataset import BinnedDataset
from ..metric import Metric, create_metric, resolve_metric_names
from ..models.linear import fit_linear_leaves, linear_values_device
from ..models.tree import Tree, kCategoricalMask, parse_tree_blocks
from ..objective import (ObjectiveFunction, create_objective,
                         load_objective_from_string)
from ..obs import events as obs_events
from ..obs import health as obs_health
from ..obs import trace as obs_trace
from ..obs.registry import registry as obs
from ..ops.predict import (build_device_tree, predict_leaf_on_device,
                           tree_output_on_device)
from ..treelearner import create_tree_learner
from ..utils import log, next_pow2
from .sample_strategy import create_sample_strategy

kEpsilon = 1e-15


def eval_hoist_due(count: int, last_count: int, eval_k: int,
                   final: bool) -> bool:
    """The eval-hoisting grid (``tpu_eval_iterations=k``; reference
    gbdt.py:76), shared by the engine's batched and per-iteration loops:
    evaluation is due when the iteration count crossed a multiple of k
    since the last evaluation (an absolute grid), always at the final or
    stopping point, and always with hoisting off (k <= 1)."""
    return (eval_k <= 1 or final
            or (count // eval_k) > (last_count // eval_k))


def run_instrumented_eval(iter_idx: int, compute):
    """The one instrumentation point of metric evaluation (reference
    gbdt.py:89): one evaluation pass is one ``gbdt::eval_metrics`` scope
    and one ``eval`` event with its results."""
    with obs.scope("gbdt::eval_metrics"):
        out = compute()
    if out and obs_events.enabled():
        obs_events.emit("eval", iter=iter_idx,
                        results=[{"dataset": ds, "metric": name,
                                  "value": float(v)}
                                 for ds, name, v, _ in out])
    return out


def device_tree_outputs(tree: Tree, bins: torch.Tensor, bin_meta,
                        raw: Optional[torch.Tensor] = None
                        ) -> Optional[torch.Tensor]:
    """[n] f32 output of one tree over binned rows ``bins`` [n, F] or,
    EFB-bundled, [n, G] (uint8 or uint16, any device), by the walk of
    ``ops/predict.py``. ``bin_meta`` is the GBDT's :class:`BinMeta`. A
    linear tree evaluates its leaves over ``raw``, the same rows' raw
    values on the device, in f64 (without them, its constant leaf
    values, as in the reference). Returns None for a zero-valued
    stump."""
    dtree = build_device_tree(tree, bin_meta[:3], bins.device,
                              bin_meta.num_bins, bin_meta.bundle)
    if dtree is None:
        if tree.leaf_value[0] != 0.0:
            return torch.full((bins.shape[0],),
                              float(np.float32(tree.leaf_value[0])),
                              dtype=torch.float32, device=bins.device)
        return None
    if tree.is_linear and raw is not None:
        return linear_values_device(
            tree, raw, predict_leaf_on_device(bins, dtree)).float()
    return tree_output_on_device(bins, dtree)


def raw_rows_on(dataset: BinnedDataset,
                device: torch.device) -> Optional[torch.Tensor]:
    """The dataset's kept raw rows on ``device`` (None when not kept)."""
    if dataset.raw_data is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(dataset.raw_data)).to(
        device)


class BinMeta(NamedTuple):
    """What the binned walks need of the training dataset: per inner
    feature its NaN bin, zero bin and missing type; the bin values' bound
    (``num_bins``) and the EFB layout of bundled rows (or None)."""
    nan_bins: np.ndarray
    zero_bins: np.ndarray
    missing_types: np.ndarray
    num_bins: int
    bundle: object


def bin_meta_of(dataset: BinnedDataset, bundled: bool = True) -> BinMeta:
    """The walks' view of ``dataset``'s rows: bundled as the dataset
    stores them, or, with ``bundled=False``, per feature (the rows of a
    learner that unbundles)."""
    m = dataset.bin_mappers
    i32 = lambda v: np.asarray(v, dtype=np.int32)  # noqa: E731
    bundle = dataset.bundle if bundled else None
    width = (bundle.num_bundled_bins if bundle is not None
             else dataset.max_num_bin)
    return BinMeta(i32([b.num_bin - 1 for b in m]),
                   i32([b.default_bin for b in m]),
                   i32([b.missing_type for b in m]),
                   next_pow2(max(int(width), 2)), bundle)


class ValidData:
    """One validation set: binned rows aligned with the training mappers
    and incrementally maintained [n, K] f32 scores, both on the device
    (reference: GBDT::AddValidDataset, gbdt.cpp:182)."""

    def __init__(self, dataset: BinnedDataset, metrics: List[Metric],
                 num_tree_per_iteration: int, device: torch.device):
        self.dataset = dataset
        self.metrics = metrics
        self.bins = torch.from_numpy(dataset.bins).to(device)
        self.raw = raw_rows_on(dataset, device)
        self.scores_dev = torch.from_numpy(
            initial_score(dataset.metadata, dataset.num_data,
                          num_tree_per_iteration)).to(device)

    @property
    def scores(self) -> np.ndarray:
        return self.scores_dev.cpu().numpy().astype(np.float64)

    def add_tree(self, tree: Tree, class_id: int, bin_meta,
                 sign: float = 1.0) -> None:
        """Add ``sign`` times the tree's f32 outputs (an f32 ``delta *
        sign`` first, as the reference; -1 takes a tree off)."""
        delta = device_tree_outputs(tree, self.bins, bin_meta, self.raw)
        if delta is not None:
            if sign != 1.0:
                delta = delta * float(np.float32(sign))
            self.scores_dev[:, class_id] += delta

    def add_const(self, val: float, class_id: int) -> None:
        self.scores_dev[:, class_id] += float(np.float32(val))

    def multiply(self, factor: float, class_id: int) -> None:
        self.scores_dev[:, class_id] *= float(np.float32(factor))


def initial_score(metadata, num_data: int, K: int) -> np.ndarray:
    """[N, K] f32 starting scores: zeros plus the metadata init_score,
    whose class-major layout (all of class 0, then class 1, ...) maps
    to the columns (reference: GBDT::_initial_score)."""
    score = np.zeros((num_data, K), dtype=np.float32)
    if metadata.init_score is not None:
        init = np.asarray(metadata.init_score, dtype=np.float64)
        score += init.reshape(K, -1).T.astype(np.float32)
    return score


class GBDT:
    """reference: src/boosting/gbdt.cpp."""

    submodel_name = "tree"
    # per-iteration host work in a subclass (DART's drops, RF's
    # averaging) cannot run inside a batch: each mode opts in
    _supports_batched = True

    def __init__(self, config: Config,
                 train_data: Optional[BinnedDataset] = None,
                 device: Optional[torch.device] = None):
        self.config = config
        self.train_data = train_data
        self.device = device
        self.objective: Optional[ObjectiveFunction] = None
        self.models: List[Tree] = []
        # validation-set tree walks deferred by train_batch until a
        # reader of the valid scores needs them: (tree, class) pairs,
        # flushed in append order, so the f32 adds are the looped ones
        self._valid_pending: List = []
        self.iter = 0
        self.num_init_iteration = 0
        self.best_iteration = -1
        self.shrinkage_rate = float(config.learning_rate)
        # the model's output is the mean of its iterations' trees (random
        # forest; the model text's ``average_output`` line)
        self.average_output = False
        # objective=none takes num_class trees per iteration from a
        # callable objective (class-major gradients)
        self.num_class = (max(int(config.num_class), 1)
                          if config.objective == "custom"
                          else config.num_tree_per_iteration)
        self.num_tree_per_iteration = self.num_class
        if train_data is not None:
            self._init_train(train_data)
        else:
            # prediction-only booster (model loaded from text)
            self.max_feature_idx = 0
            self.feature_names: List[str] = []
            self.feature_infos: List[str] = []
            self.label_idx = 0
            self.monotone_constraints: List[int] = []

    # ------------------------------------------------------------------
    def _init_train(self, train_data: BinnedDataset) -> None:
        config = self.config
        config.check_slice()
        K = self.num_class
        if config.objective != "custom":
            self.objective = create_objective(config.objective, config)
            self.objective.init(train_data.metadata, train_data.num_data,
                                self.device)
            K = self.objective.num_model_per_iteration
            if (self.objective.is_renew_tree_output
                    and any(int(v) != 0
                            for v in config.monotone_constraints)):
                # leaf renewal overwrites the clamped outputs, so
                # monotonicity cannot hold (reference gbdt.py:241-247;
                # upstream gbdt.cpp:94)
                log.fatal("Cannot use ``monotone_constraints`` in %s "
                          "objective, please disable it."
                          % config.objective)
        self.num_tree_per_iteration = K
        self.num_data = train_data.num_data
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = train_data.feature_infos()
        self.label_idx = 0
        mc = train_data.monotone_constraints
        self.monotone_constraints = ([] if mc is None
                                     else [int(v) for v in np.asarray(mc)])
        self._raw = None
        if config.linear_tree:
            if train_data.raw_data is None:
                log.fatal("linear_tree requires raw data; construct the "
                          "Dataset with keep_raw_data=True")
            self._raw = raw_rows_on(train_data, self.device)
        self.learner = self._make_learner(config, train_data)
        self.sample_strategy = create_sample_strategy(
            config, train_data.num_data, self.device)
        self.sample_strategy.reset_metadata(train_data.metadata)
        self._has_init_score = train_data.metadata.init_score is not None
        self.train_score = torch.from_numpy(initial_score(
            train_data.metadata, self.num_data, K)).to(self.device)
        self.class_need_train = [
            self.objective is None or self.objective.class_need_train(k)
            for k in range(K)]
        self.train_metrics: List[Metric] = []
        self.valid_data: List[ValidData] = []
        self._bin_meta = bin_meta_of(train_data)
        # the learner's own rows (``learner.bins``), per feature where it
        # unbundles a bundled dataset
        self._train_bin_meta = bin_meta_of(
            train_data, getattr(self.learner, "_bundled", True))
        obs_health.record_backend_once(source="gbdt_init",
                                       device=self.device)

    def _make_learner(self, config: Config, train_data: BinnedDataset):
        """The tree learner (the multi-process trainer brings its own)."""
        return create_tree_learner(config, train_data, self.device)

    def add_valid_data(self, valid_data: BinnedDataset) -> None:
        """reference: GBDT::AddValidDataset (gbdt.cpp:182)."""
        if not hasattr(valid_data, "bins"):
            # a validation set's rows and scores stay on the device; a
            # sharded (out-of-core) dataset has no resident matrix
            log.fatal("sharded datasets cannot be validation sets; bin "
                      "the validation rows in memory (they are scored "
                      "per tree, not histogrammed)")
        # deferred walks belong to the sets registered before this one,
        # which replays the whole model below
        self._flush_valid_pending()
        metrics = []
        for name in resolve_metric_names(self.config, self.config.objective):
            m = create_metric(name, self.config)
            if m is not None:
                m.init(valid_data.metadata, valid_data.num_data)
                metrics.append(m)
        vd = ValidData(valid_data, metrics, self.num_tree_per_iteration,
                       self.device)
        for i, tree in enumerate(self.models):
            vd.add_tree(tree, i % self.num_tree_per_iteration,
                        self._bin_meta)
        self.valid_data.append(vd)

    # ------------------------------------------------------------------
    def _boost_from_average(self, class_id: int) -> float:
        """reference: GBDT::BoostFromAverage (gbdt.cpp:309)."""
        if self.models or self._has_init_score or self.objective is None:
            return 0.0
        if self.config.boost_from_average:
            init_score = self.objective.boost_from_score(class_id)
            if abs(init_score) > kEpsilon:
                self._add_const_score(init_score, class_id)
                log.info("Start training from score %f" % init_score)
                return init_score
        elif self.objective.name in ("regression_l1", "quantile", "mape"):
            log.warning("Disabling boost_from_average in %s may cause the "
                        "slow convergence" % self.objective.name)
        return 0.0

    def _add_const_score(self, val: float, class_id: int) -> None:
        self.train_score[:, class_id] += float(np.float32(val))
        for vd in self.valid_data:
            vd.add_const(val, class_id)

    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration: K trees, one per class (reference:
        GBDT::TrainOneIter, gbdt.cpp:334). ``grad`` and ``hess`` (host
        arrays of N values, or K * N class-major ones) come from a
        callable objective; without them the objective computes them.
        Returns True when training should stop (no tree of the iteration
        could split)."""
        t_iter0 = time.perf_counter()
        K = self.num_tree_per_iteration
        with obs.scope("gbdt::gradients"):
            if grad is None or hess is None:
                if self.objective is None:
                    log.fatal("No objective function provided: "
                              "objective=none takes its gradients from a "
                              "callable objective (train's "
                              "params['objective'], or "
                              "Booster.update(fobj=...); ROADMAP item 18a)")
                init_scores = [self._boost_from_average(k)
                               for k in range(K)]
                score = (self.train_score[:, 0] if K == 1
                         else self.train_score)
                grad, hess = self.objective.get_gradients(score)
            else:
                init_scores = [0.0] * K
                grad, hess = (self._host_gradient(v) for v in (grad, hess))
            obs.watch_ready("gbdt::gradients", (grad, hess))
        with obs.scope("gbdt::bagging"):
            grad, hess, bag = self.sample_strategy.bagging(self.iter, grad,
                                                           hess)
        should_continue = False
        new_trees = []
        for k in range(K):
            # one class column at a time, made contiguous for the learner
            gk = grad if K == 1 else grad[:, k].contiguous()
            hk = hess if K == 1 else hess[:, k].contiguous()
            tree: Optional[Tree] = None
            if self.class_need_train[k]:
                with obs.scope("tree::grow"):
                    tree, leaf_of_row = self.learner.train(gk, hk, bag)
            if tree is not None and tree.num_leaves > 1:
                should_continue = True
                if self.config.linear_tree:
                    # raw rows keep every original column and
                    # split_feature holds original column indices
                    fit_linear_leaves(
                        tree, self._raw, gk, hk, leaf_of_row,
                        float(self.config.linear_lambda),
                        None if bag is None else bag > 0)
                if (self.objective is not None
                        and self.objective.is_renew_tree_output):
                    self._renew_tree_output(tree, leaf_of_row, k, bag)
                tree.apply_shrinkage(self.shrinkage_rate)
                self._update_score(tree, leaf_of_row, k)
                if abs(init_scores[k]) > kEpsilon:
                    tree.add_bias(init_scores[k])
            else:
                tree = Tree(1)
                # constant trees the first iteration (reference:
                # gbdt.cpp:407-418)
                if len(self.models) < K:
                    if (self.objective is not None
                            and not self.config.boost_from_average
                            and not self._has_init_score):
                        init_scores[k] = self.objective.boost_from_score(k)
                        self._add_const_score(init_scores[k], k)
                    tree.leaf_value[0] = init_scores[k]
            new_trees.append(tree)
        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) >= K:
                return True
        self.models.extend(new_trees)
        self.iter += 1
        self._emit_iter_event(new_trees, t_iter0)
        return not should_continue

    def _emit_iter_event(self, new_trees: List[Tree], t_start: float,
                         batched: bool = False,
                         seconds: Optional[float] = None) -> None:
        """The per-iteration ``train_iter`` event (reference gbdt.py:475)
        and the per-iteration telemetry tick (device memory gauges, the
        metrics exporter; ``obs/trace.py::sample_iteration``): outside
        the captured step, cheap when telemetry is off."""
        obs_trace.sample_iteration(self.iter)
        if not obs_events.enabled():
            return
        if seconds is None:
            seconds = time.perf_counter() - t_start
        trees = [{"num_leaves": int(t.num_leaves),
                  "depth": int(t.leaf_depth[:max(t.num_leaves, 1)].max())}
                 for t in new_trees if t is not None]
        obs_events.emit("train_iter", iter=self.iter,
                        seconds=round(seconds, 6), batched=batched,
                        trees=trees)

    # ------------------------------------------------------------------
    # batched iterations (reference gbdt.py:504-700)
    # ------------------------------------------------------------------
    def can_train_batched(self) -> bool:
        """True when T iterations can run with no host work between them
        (reference gbdt.py:509): a mode that opts in, an objective with
        gradients that are a function of the score alone (no leaf
        renewal, no fresh draw per call), no linear fits, a sample
        strategy with a device draw, iteration 0 done (it boosts from
        the average), every class trained, and a learner whose
        whole-tree loop needs no host state."""
        return (self._supports_batched
                and self.objective is not None
                and not self.objective.is_renew_tree_output
                and not self.objective.has_stochastic_gradients
                and not self.config.linear_tree
                and self.sample_strategy.supports_device_draw()
                and len(self.models) >= 1
                and all(self.class_need_train)
                and self.learner.supports_train_many())

    def train_batch(self, n_iters: int) -> bool:
        """Run ``n_iters`` iterations through the learner's
        ``train_many`` (one record read for all of them) and replay the
        records into host trees (reference gbdt.py:529). Returns True
        when training should stop: an iteration grew no tree in any
        class, and it and every later one of the batch are dropped, as
        the looped path stops there. Callers check
        :meth:`can_train_batched` first."""
        from ..treelearner.serial import (SplitRecord, apply_split_record,
                                          record_is_valid)
        from .sample_strategy import SampleStrategy
        t_batch0 = time.perf_counter()
        learner = self.learner
        K = self.num_tree_per_iteration
        sample = (None if type(self.sample_strategy) is SampleStrategy
                  else self.sample_strategy)
        with obs.scope("tree::train_batch_dispatch"):
            recs = learner.train_many(
                self.objective.get_gradients, sample, self.train_score,
                list(range(self.iter, self.iter + n_iters)),
                self.shrinkage_rate).tolist()
        t_dispatch = time.perf_counter() - t_batch0
        applied, stopped = 0, False
        for t in range(n_iters):
            iter_trees = []
            for k in range(K):
                tree = Tree(learner.L)
                for row in recs[t][k]:
                    rec = SplitRecord.from_row(int(row[0]), row[1:],
                                               learner.layout)
                    if not record_is_valid(rec):
                        break
                    apply_split_record(tree, self.train_data, rec)
                if tree.num_leaves > 1:
                    tree.apply_shrinkage(self.shrinkage_rate)
                else:
                    # a class that grew nothing: the looped path's
                    # zero-valued stump (the device added nothing)
                    tree = Tree(1)
                iter_trees.append(tree)
            if all(tree.num_leaves <= 1 for tree in iter_trees):
                log.warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
                stopped = True
                break
            with obs.scope("tree::apply_records"):
                for k, tree in enumerate(iter_trees):
                    self.models.append(tree)
                    if tree.num_leaves > 1 and self.valid_data:
                        self._valid_pending.append((tree, k))
            self.iter += 1
            applied += 1
            # the batch's wall time spread over its iterations
            self._emit_iter_event(iter_trees, 0.0, batched=True,
                                  seconds=t_dispatch / n_iters)
        if obs_events.enabled():
            obs_events.emit("train_batch", n_iters=n_iters, applied=applied,
                            stopped=stopped, seconds=round(t_dispatch, 6))
        return stopped

    def _flush_valid_pending(self) -> None:
        """Walk the validation sets through the trees that
        :meth:`train_batch` deferred (reference gbdt.py:637); every
        reader of the valid scores (evaluation, rollback, a later
        ``add_valid_data``) calls it first."""
        if not self._valid_pending:
            return
        pending, self._valid_pending = self._valid_pending, []
        with obs.scope("tree::apply_records"):
            for tree, k in pending:
                for vd in self.valid_data:
                    vd.add_tree(tree, k, self._bin_meta)

    def recheck_scores(self, reason: str = "") -> float:
        """Replay every tree over the training rows on the device and
        compare the sum with the maintained training score (reference
        gbdt.py:662); called once where a quantized batched run hands
        over to the per-iteration loop, and by a checkpoint resume (over
        a sharded dataset too, shard by shard, which the reference
        skips). Emits
        one ``batched_eval_recheck`` event, and warns when the largest
        deviation passes 1e-3 times the score's scale; returns the
        deviation."""
        K = self.num_tree_per_iteration
        replay = torch.from_numpy(initial_score(
            self.train_data.metadata, self.num_data, K)).to(self.device)
        # block by block over the learner's rows: the resident matrix at
        # once, or a sharded dataset's shards as they stage
        for lo, bins in self.learner.bin_blocks():
            block = replay[lo:lo + bins.shape[0]]
            raw = (None if self._raw is None
                   else self._raw[lo:lo + bins.shape[0]])
            for i, tree in enumerate(self.models):
                delta = device_tree_outputs(tree, bins,
                                            self._train_bin_meta, raw)
                if delta is not None:
                    block[:, i % K] += delta
        diff = float((replay - self.train_score).abs().max())
        scale = max(float(self.train_score.abs().max()), 1.0)
        ok = diff <= 1e-3 * scale
        obs_events.emit("batched_eval_recheck", reason=reason,
                        iter=self.iter, trees=len(self.models),
                        max_abs_diff=round(diff, 9), ok=ok)
        if not ok:
            log.warning("batched-eval recheck (%s) found score deviation "
                        "%.3g (replay of %d trees vs the maintained "
                        "device score)" % (reason or "batched_to_looped",
                                           diff, len(self.models)))
        return diff

    def save_checkpoint(self, directory: str,
                        keep: Optional[int] = None) -> str:
        """Write one atomically finalized checkpoint directory of the
        whole resume state (``ft/checkpoint.py``); returns its path."""
        from ..ft import checkpoint as _ckpt
        return _ckpt.save(self, directory, keep=keep)

    def load_checkpoint(self, directory: str) -> Optional[Dict]:
        """Restore this (fresh, same-dataset) booster from the newest
        valid checkpoint under ``directory``; returns its state dict, or
        None when there is none. Corrupt checkpoints are skipped
        loudly."""
        from ..ft import checkpoint as _ckpt
        return _ckpt.load_latest(self, directory)

    def _host_gradient(self, v) -> torch.Tensor:
        """A callable objective's gradient or hessian on the device:
        f32 [N], or [N, K] from K * N class-major values."""
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(v, dtype=np.float32).reshape(-1))).to(self.device)
        K = self.num_tree_per_iteration
        if t.numel() != K * self.num_data:
            log.fatal("a custom objective returned %d values; expected "
                      "num_data * num_class = %d"
                      % (t.numel(), K * self.num_data))
        return t if K == 1 else t.view(K, self.num_data).t().contiguous()

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees and take their outputs off the
        training and validation scores (reference:
        GBDT::RollbackOneIter, gbdt.cpp:438)."""
        if self.iter <= 0:
            return
        self._flush_valid_pending()
        K = self.num_tree_per_iteration
        bins = self.learner.bins
        for k in range(K):
            tree = self.models[-K + k]
            delta = device_tree_outputs(tree, bins, self._train_bin_meta,
                                        self._raw)
            if delta is not None:
                self.train_score[:, k].sub_(delta)
            for vd in self.valid_data:
                vd.add_tree(tree, k, self._bin_meta, sign=-1.0)
        del self.models[-K:]
        self.iter -= 1

    def replay_init_model(self, models: List[Tree]) -> None:
        """Continued training: preload ``models`` (text-loaded trees),
        re-link them to this dataset's bins and add their f32 outputs to
        the training scores in tree order (reference: engine.train's
        ``init_model`` replay, lightgbm_tpu/engine.py:81-101). No
        boost-from-average follows."""
        self.models = list(models)
        self.num_init_iteration = self.current_iteration
        self.align_trees_to_dataset(self.train_data)
        bins = self.learner.bins
        K = self.num_tree_per_iteration
        for i, tree in enumerate(self.models):
            delta = device_tree_outputs(tree, bins, self._train_bin_meta,
                                        self._raw)
            if delta is not None:
                self.train_score[:, i % K] += delta
        self._has_init_score = True

    def align_trees_to_dataset(self, dataset: BinnedDataset) -> None:
        """Give text-loaded trees the bin-space node fields
        (``split_feature_inner``, ``threshold_in_bin``, the bin masks of
        categorical nodes) of ``dataset``'s bin mappers, for the binned
        walks (reference: ``GBDT.align_trees_to_dataset``,
        gbdt.py:1231)."""
        inner_of = {f: j for j, f in enumerate(dataset.used_feature_map)}
        for tree in self.models:
            for node in range(tree.num_internal):
                inner = inner_of.get(int(tree.split_feature[node]), -1)
                tree.split_feature_inner[node] = max(inner, 0)
                if inner < 0:
                    continue
                mapper = dataset.bin_mappers[inner]
                if tree.decision_type[node] & kCategoricalMask:
                    # a bin goes left when its category is in the node's
                    # bitset (bin 0, NaN and others, never is)
                    cats = np.array(
                        [mapper.bin_2_categorical[b]
                         if b < len(mapper.bin_2_categorical) else -1
                         for b in range(mapper.num_bin)], dtype=np.float64)
                    tree.cat_bin_masks[node] = tree._cat_contains(
                        int(tree.threshold_in_bin[node]), cats)
                else:
                    tree.threshold_in_bin[node] = mapper.value_to_bin(
                        np.array([tree.threshold[node]]))[0]

    def reset_config(self, config: Config) -> None:
        """Take new parameters between iterations (reference:
        GBDT::ResetConfig and ``ops_refresh.refresh_learner_params``):
        the shrinkage, the bagging draw and the learner's split
        parameters and depth limit. The captured split step holds the
        old ones as constants, so it is dropped and the next tree
        captures it again."""
        config.check_slice()
        self.config = config
        self.shrinkage_rate = float(config.learning_rate)
        if self.train_data is not None:
            self.learner.reset_config(config)
            self.sample_strategy.refresh_config(config)

    def _renew_tree_output(self, tree: Tree, leaf_of_row: torch.Tensor,
                           class_id: int, bag: Optional[torch.Tensor]
                           ) -> None:
        """Leaf renewal on the host (reference: gbdt.py:433-444): the
        class's score column, the row->leaf partition and the in-bag
        rows are copied from the device for the objective's
        percentiles."""
        self.objective.renew_tree_output(
            tree,
            self.train_score[:, class_id].double().cpu().numpy(),
            leaf_of_row.cpu().numpy(),
            None if bag is None else bag.cpu().numpy() > 0)

    def _update_score(self, tree: Tree, leaf_of_row: torch.Tensor,
                      class_id: int) -> None:
        """Device gather of the tree's f32 leaf outputs over the
        learner's final partition (reference: GBDT::UpdateScore,
        gbdt.cpp:475; leaf values cast to f32 as at gbdt.py:722-727); a
        linear tree's f64 outputs over the raw rows, cast to f32."""
        with obs.scope("gbdt::score_update"):
            self._update_score_inner(tree, leaf_of_row, class_id)
            obs.watch_ready("gbdt::score_update", self.train_score)

    def _update_score_inner(self, tree: Tree, leaf_of_row: torch.Tensor,
                            class_id: int) -> None:
        if tree.is_linear:
            self.train_score[:, class_id] += linear_values_device(
                tree, self._raw, leaf_of_row).float()
        else:
            lv = torch.from_numpy(
                tree.leaf_value[:tree.num_leaves].astype(np.float32)).to(
                self.device)
            self.train_score[:, class_id] += lv[leaf_of_row.long()]
        for vd in self.valid_data:
            vd.add_tree(tree, class_id, self._bin_meta)

    # ------------------------------------------------------------------
    # Prediction over raw feature matrices (host walk)
    # ------------------------------------------------------------------
    def _used_models(self, start_iteration: int = 0,
                     num_iteration: int = -1) -> List[Tree]:
        K = self.num_tree_per_iteration
        total_iter = len(self.models) // K
        start = max(0, min(start_iteration, total_iter))
        end = total_iter if num_iteration <= 0 \
            else min(start + num_iteration, total_iter)
        return self.models[start * K:end * K]

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1,
                    pred_early_stop: Optional[bool] = None,
                    pred_early_stop_freq: Optional[int] = None,
                    pred_early_stop_margin: Optional[float] = None
                    ) -> np.ndarray:
        """[n] raw scores, or [n, K] for a multiclass model."""
        X = np.asarray(X, dtype=np.float64)
        K = self.num_tree_per_iteration
        n = X.shape[0]
        out = np.zeros((n, K), dtype=np.float64)
        models = self._used_models(start_iteration, num_iteration)
        if pred_early_stop is None:
            pred_early_stop = bool(self.config.pred_early_stop)
        if pred_early_stop and self.objective is not None \
                and self.objective.name in ("binary", "multiclass",
                                            "multiclassova"):
            # margin-based per-row early exit (reference:
            # src/boosting/prediction_early_stop.cpp: binary margin
            # 2|score|, multiclass top1 - top2, checked every round_period
            # iterations)
            freq = max(int(pred_early_stop_freq
                           if pred_early_stop_freq is not None
                           else self.config.pred_early_stop_freq), 1)
            margin_thr = float(pred_early_stop_margin
                               if pred_early_stop_margin is not None
                               else self.config.pred_early_stop_margin)
            active = np.arange(n)
            n_iters = len(models) // K
            for it in range(n_iters):
                if len(active) == 0:
                    break
                Xa = X[active]
                for k in range(K):
                    out[active, k] += models[it * K + k].predict(Xa)
                if (it + 1) % freq == 0 and it + 1 < n_iters:
                    if K == 1:
                        margin = 2.0 * np.abs(out[active, 0])
                    else:
                        part = np.partition(out[active], K - 2, axis=1)
                        margin = part[:, K - 1] - part[:, K - 2]
                    active = active[margin < margin_thr]
        else:
            for i, tree in enumerate(models):
                out[:, i % K] += tree.predict(X)
        if self.average_output and models:
            out /= max(len(models) // K, 1)
        return out[:, 0] if K == 1 else out

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                pred_early_stop: Optional[bool] = None,
                pred_early_stop_freq: Optional[int] = None,
                pred_early_stop_margin: Optional[float] = None
                ) -> np.ndarray:
        raw = self.predict_raw(X, start_iteration, num_iteration,
                               pred_early_stop, pred_early_stop_freq,
                               pred_early_stop_margin)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    def predict_leaf_index(self, X: np.ndarray, start_iteration: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        models = self._used_models(start_iteration, num_iteration)
        out = np.zeros((X.shape[0], len(models)), dtype=np.int32)
        for i, tree in enumerate(models):
            out[:, i] = tree.predict_leaf_index(X)
        return out

    def predict_contrib(self, X: np.ndarray, start_iteration: int = 0,
                        num_iteration: int = -1) -> np.ndarray:
        """SHAP contributions (reference gbdt.py:1028; upstream
        Tree::PredictContrib, tree.h:139), host TreeSHAP."""
        from ..models.shap import predict_contrib
        return predict_contrib(
            self._used_models(start_iteration, num_iteration), X,
            self.max_feature_idx + 1, self.num_tree_per_iteration)

    def save_model_to_cpp(self, filename: str) -> None:
        """The model as a standalone C++ source (reference gbdt.py:1165;
        upstream GBDT::SaveModelToIfElse), written atomically."""
        from ..models.codegen import model_to_cpp
        from ..utils.atomic import atomic_write
        atomic_write(filename, model_to_cpp(self))

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """reference: GBDT::FeatureImportance."""
        imp = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for tree in self._used_models(0, num_iteration):
            for j in range(tree.num_internal):
                f = tree.split_feature[j]
                if importance_type == "split":
                    imp[f] += 1.0
                else:
                    imp[f] += max(tree.split_gain[j], 0.0)
        return imp

    # ------------------------------------------------------------------
    # Model text I/O (reference: src/boosting/gbdt_model_text.cpp)
    # ------------------------------------------------------------------
    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1) -> str:
        """reference: GBDT::SaveModelToString (gbdt_model_text.cpp:311)."""
        lines = [self.submodel_name, "version=v3",
                 "num_class=%d" % self.num_class,
                 "num_tree_per_iteration=%d" % self.num_tree_per_iteration,
                 "label_index=%d" % self.label_idx,
                 "max_feature_idx=%d" % self.max_feature_idx]
        if self.objective is not None:
            lines.append("objective=%s" % self.objective.to_string())
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        if self.monotone_constraints:
            lines.append("monotone_constraints=" + " ".join(
                str(v) for v in self.monotone_constraints))
        lines.append("feature_infos=" + " ".join(self.feature_infos))
        models = self._used_models(start_iteration, num_iteration)
        tree_strs = ["Tree=%d\n%s\n" % (i, tree.to_string())
                     for i, tree in enumerate(models)]
        lines.append("tree_sizes=" + " ".join(str(len(s))
                                              for s in tree_strs))
        lines.append("")
        out = "\n".join(lines) + "\n" + "".join(tree_strs)
        out += "end of trees\n"
        imp_type = ("gain" if int(self.config.saved_feature_importance_type)
                    == 1 else "split")
        imp = self.feature_importance(imp_type, num_iteration)
        pairs = [(imp[i], self.feature_names[i])
                 for i in range(len(imp)) if imp[i] > 0]
        pairs.sort(key=lambda p: -p[0])
        out += "\nfeature_importances:\n"
        for v, name in pairs:
            out += ("%s=%d\n" % (name, int(v)) if imp_type == "split"
                    else "%s=%s\n" % (name, repr(float(v))))
        out += "\nparameters:\n%s\nend of parameters\n" % \
            self.config.to_param_string()
        return out

    def dump_model(self, start_iteration: int = 0, num_iteration: int = -1,
                   importance_type: str = "split") -> Dict:
        """The model as a JSON-serializable dict (reference:
        GBDT::DumpModel, gbdt_model_text.cpp:21-170)."""
        d: Dict = {
            "name": self.submodel_name,
            "version": "v3",
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": self.label_idx,
            "max_feature_idx": self.max_feature_idx,
        }
        if self.objective is not None:
            d["objective"] = self.objective.to_string()
        d["average_output"] = bool(self.average_output)
        d["feature_names"] = list(self.feature_names)
        d["monotone_constraints"] = list(self.monotone_constraints)
        infos: Dict = {}
        for name, info in zip(self.feature_names, self.feature_infos):
            if info.startswith("["):
                lo, hi = info[1:-1].split(":")
                infos[name] = {"min_value": float(lo),
                               "max_value": float(hi), "values": []}
            elif info != "none":
                vals = [int(v) for v in info.split(":")]
                infos[name] = {"min_value": min(vals),
                               "max_value": max(vals), "values": vals}
        d["feature_infos"] = infos
        d["tree_info"] = [dict(tree.to_json(), tree_index=i)
                          for i, tree in enumerate(self._used_models(
                              start_iteration, num_iteration))]
        imp = self.feature_importance(importance_type, num_iteration)
        d["feature_importances"] = {
            self.feature_names[i]: (int(imp[i]) if importance_type == "split"
                                    else float(imp[i]))
            for i in range(len(imp)) if imp[i] > 0}
        return d

    def load_model_from_string(self, s: str) -> None:
        """reference: GBDT::LoadModelFromString
        (gbdt_model_text.cpp:421)."""
        lines = s.splitlines()
        kv: Dict[str, str] = {}
        i = 0
        while i < len(lines) and not lines[i].startswith("Tree="):
            if "=" in lines[i]:
                k, v = lines[i].split("=", 1)
                kv[k] = v
            elif lines[i].strip() == "average_output":
                self.average_output = True
            i += 1
        self.num_class = int(kv.get("num_class", 1))
        self.num_tree_per_iteration = int(
            kv.get("num_tree_per_iteration", self.num_class))
        self.label_idx = int(kv.get("label_index", 0))
        self.max_feature_idx = int(kv.get("max_feature_idx", 0))
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos = kv.get("feature_infos", "").split()
        if "objective" in kv:
            self.objective = load_objective_from_string(kv["objective"],
                                                        self.config)
        self.models = parse_tree_blocks("\n".join(lines[i:]))
        self.num_init_iteration = \
            len(self.models) // self.num_tree_per_iteration
        self.iter = 0

    @property
    def current_iteration(self) -> int:
        return len(self.models) // self.num_tree_per_iteration
