"""Training entry points ``train`` and ``cv``.

Port of ``lightgbm_tpu/engine.py`` (API after the reference's
python-package/lightgbm/engine.py: ``train`` at :36, ``cv`` at :516 with
``CVBooster`` :280 and the folds of ``_make_n_folds`` :432), with the
reference's arguments in the reference's order: dataset construction,
validation sets aligned to the training bins, a callable objective,
``feval``, ``init_model`` (continued training), evaluation and the
callbacks (``early_stopping`` is also armed by the
``early_stopping_round`` param). ``tpu_batch_iterations=T`` runs full
batches of T iterations with one host read each
(``GBDT.train_batch``); ``tpu_eval_iterations=k`` evaluates on the
absolute every-k grid (``gbdt.eval_hoist_due``). Checkpoints
(``checkpoint_dir``, ``checkpoint_freq``, ``resume``; reference
engine.py:105-160, ``ft/checkpoint.py``): a checkpoint after every
``checkpoint_freq``-th iteration's evaluation and callbacks (in a batched
run, at the batch ends that reach a multiple), and one at the end;
``resume=True`` continues from the newest valid one, with the
early-stopping callback's state.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .boosting.gbdt import eval_hoist_due
from .config import Config
from .utils import log

_NUM_ROUND_KEYS = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                   "num_trees", "num_round", "num_rounds", "nrounds",
                   "num_boost_round", "n_estimators", "max_iter")


def _pop_callable_objective(params: Dict[str, Any]):
    """Take a callable objective out of ``params`` in place, leaving
    ``"none"`` (Config parses strings only); returns it, or None."""
    obj = params.get("objective")
    if callable(obj):
        params["objective"] = "none"
        return obj
    return None


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval: Optional[Union[Callable, List[Callable]]] = None,
          init_model: Optional[Union[str, Booster]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          checkpoint_dir: Optional[str] = None,
          checkpoint_freq: int = 0,
          resume: bool = False) -> Booster:
    """Train a GBDT model (reference: engine.py:36). Runs on
    ``params["device_type"]``: ``cuda`` by default, ``cpu`` on request.

    ``params["objective"]`` may be a callable ``fobj(preds, train_set) ->
    (grad, hess)``. ``init_model`` (a Booster or a model file) continues
    training: its trees are kept, and their outputs start the training
    scores. The returned Booster keeps its training state whatever
    ``keep_training_booster`` says, as in the reference.

    ``checkpoint_dir`` with ``checkpoint_freq=k`` writes a checkpoint
    after every k-th iteration and one at the end; ``resume=True``
    continues from the newest valid checkpoint there (from scratch when
    there is none), bit for bit as the uninterrupted run."""
    params = dict(params or {})
    fobj = _pop_callable_objective(params)
    cfg = Config.from_params(params)
    if any(k in params for k in _NUM_ROUND_KEYS):
        num_boost_round = cfg.num_iterations

    merged = dict(params, **(train_set.params or {}))
    fobj = _pop_callable_objective(merged) or fobj
    train_set.params = merged
    train_set.construct()
    booster = Booster(params=params, train_set=train_set)
    # a spilled dataset carries its training-grid reference profile
    # (obs/quality.py): the booster keeps it, so checkpoints write it
    spill_profile = getattr(booster.inner.train_data, "quality_profile",
                            None)
    if spill_profile is not None:
        booster.inner.quality_profile = spill_profile
    if init_model is not None:
        base = Booster(params=params, model_str=_model_text(init_model))
        booster.inner.replay_init_model(base.inner.models)

    ckpt_state = None
    if checkpoint_dir and resume:
        ckpt_state = booster.inner.load_checkpoint(checkpoint_dir)
        if ckpt_state is None:
            log.info("resume=True but no valid checkpoint under %s; "
                     "training from scratch" % checkpoint_dir)
    resume_iter = booster.inner.iter if ckpt_state is not None else 0

    def maybe_checkpoint(force: bool = False) -> None:
        it = booster.inner.iter
        if checkpoint_dir and (force or (checkpoint_freq > 0 and it > 0
                                         and it % checkpoint_freq == 0)):
            booster.inner.save_checkpoint(checkpoint_dir)
        if force:
            # the end of training (every return forces the last
            # checkpoint): the sharded learner drops the sweep it started
            # for a next tree, which holds a staged shard
            release = getattr(booster.inner.learner, "release_prefetch",
                              None)
            if release is not None:
                release()

    valid_sets = valid_sets or []
    valid_names = valid_names or []
    eval_train = False
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            eval_train = True
            continue
        vs.reference = vs.reference or train_set
        vs.params = dict(params, **(vs.params or {}))
        booster.add_valid(vs, valid_names[i] if i < len(valid_names)
                          else "valid_%d" % i)

    callbacks_before, callbacks_after = _sorted_callbacks(cfg, callbacks)
    # the early-stopping callback's state rides in every checkpoint, so
    # a resumed run continues its patience window
    stateful = [cb for cb in callbacks_after
                if hasattr(cb, "get_state") and hasattr(cb, "set_state")]
    if ckpt_state is not None and stateful:
        saved = (ckpt_state.get("engine") or {}).get("early_stopping")
        for cb, st in zip(stateful, saved or []):
            cb.set_state(st)

    def engine_state():
        states = [cb.get_state() for cb in stateful]
        if not any(s is not None for s in states):
            return None
        return {"early_stopping": states}

    booster.inner._engine_state_provider = engine_state

    def run_callbacks(cbs, i, results):
        for cb in cbs:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=results))

    def evaluate(i):
        """Evaluate, then run the after-iteration callbacks for
        iteration ``i``; returns the results and whether early stopping
        fired (the booster then holds its best iteration and scores)."""
        results = booster.eval_train(feval) if eval_train else []
        results.extend(booster.eval_valid(feval))
        try:
            run_callbacks(callbacks_after, i, results)
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for item in (e.best_score or []):
                booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
            return results, True
        return results, False

    eval_k = max(int(cfg.tpu_eval_iterations), 1)
    if eval_k > 1 and (callbacks_after or valid_sets):
        log.info("tpu_eval_iterations=%d: evaluation and callbacks run "
                 "when the iteration count crosses a multiple of %d"
                 % (eval_k, eval_k))
    batch_n = int(cfg.tpu_batch_iterations)
    inner = booster.inner
    start_i = resume_iter
    evaluation_result_list: List = []
    if batch_n > 1 and fobj is None:
        # reference engine.py:218-300: iteration 0 looped (it boosts from
        # the average), then full batches only; evaluation and callbacks
        # at batch ends, with the batch's last iteration index
        i = last_eval = resume_iter
        degraded = ran_batched = rechecked = False
        while i < num_boost_round and not degraded:
            run_callbacks(callbacks_before, i, None)
            if inner.can_train_batched() and num_boost_round - i >= batch_n:
                finished = inner.train_batch(batch_n)
                i += batch_n
                ran_batched = True
            else:
                if ran_batched and not rechecked and cfg.use_quantized_grad:
                    # a quantized run leaving the batches: check the
                    # maintained scores once against a replay
                    inner.recheck_scores(reason="batched_to_looped")
                    rechecked = True
                finished = booster.update()
                i += 1
                if not finished and not inner.can_train_batched():
                    log.warning(
                        "tpu_batch_iterations=%d ignored: the "
                        "configuration needs per-iteration host work "
                        "(per-node masks / feature_fraction / monotone "
                        "/ CEGB / forced splits / linear / leaf-output "
                        "renewal, a stochastic-gradient objective, "
                        "DART/RF boosting, or tpu_fused_tree=false)"
                        % batch_n)
                    degraded = True
            if eval_hoist_due(i, last_eval, eval_k,
                              finished or degraded or i >= num_boost_round):
                last_eval = i
                evaluation_result_list, stopped = evaluate(i - 1)
                if stopped:
                    maybe_checkpoint(force=True)
                    return booster
            # after this boundary's evaluation and callbacks, so the
            # callback state covers exactly the iterations done
            maybe_checkpoint()
            if finished:
                break
        if not degraded:
            maybe_checkpoint(force=True)
            return _fill_best(booster, evaluation_result_list)
        start_i = i
    elif batch_n > 1:
        log.warning("tpu_batch_iterations=%d ignored: a custom objective "
                    "needs per-iteration gradients" % batch_n)

    for i in range(start_i, num_boost_round):
        run_callbacks(callbacks_before, i, None)
        finished = booster.update(fobj=fobj)
        if eval_hoist_due(i + 1, i, eval_k,
                          finished or i == num_boost_round - 1):
            evaluation_result_list, stopped = evaluate(i)
            if stopped:
                break
        maybe_checkpoint()
        if finished:
            break
    maybe_checkpoint(force=True)
    return _fill_best(booster, evaluation_result_list)


def _model_text(init_model: Union[str, Booster]) -> str:
    """The text of ``init_model``: a Booster, or a model file."""
    if isinstance(init_model, Booster):
        return init_model.model_to_string()
    with open(init_model) as fh:
        return fh.read()


def _sorted_callbacks(cfg: Config, callbacks):
    """The before- and after-iteration callbacks, each sorted by
    ``order``, with ``early_stopping`` added for
    ``early_stopping_round``."""
    callbacks = list(callbacks or [])
    if cfg.early_stopping_round > 0 and not any(
            getattr(cb, "order", 0) == 30 for cb in callbacks):
        callbacks.append(callback_mod.early_stopping(
            cfg.early_stopping_round,
            first_metric_only=cfg.first_metric_only,
            verbose=cfg.verbosity >= 0))
    key = lambda cb: getattr(cb, "order", 0)  # noqa: E731
    return (sorted((cb for cb in callbacks
                    if getattr(cb, "before_iteration", False)), key=key),
            sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)), key=key))


def _fill_best(booster: Booster, evaluation_result_list) -> Booster:
    """Without early stopping, the best iteration is the last and the
    best scores are the last evaluation's."""
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration
        for item in evaluation_result_list:
            booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    return booster


class CVBooster:
    """The boosters of the folds (reference: engine.py:280); a method
    called on it is called on every booster and gives their results in
    fold order."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs)
                    for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, params,
                  seed: int, stratified: bool, shuffle: bool):
    """(train, test) row indices of each fold (reference engine.py:432):
    ``folds`` as given (an iterable of pairs, or a splitter with
    ``split``, which gets the query id of every row as ``groups``);
    else whole queries per fold for ranking data, label-stratified
    folds, or plain ones, all from ``RandomState(seed)``."""
    full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            group = full_data.get_group()
            flatted_group = (np.repeat(np.arange(len(group)), group)
                             if group is not None
                             else np.zeros(num_data, dtype=np.int64))
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(),
                                groups=flatted_group)
        return list(folds)
    rng = np.random.RandomState(seed)
    group = full_data.get_group()
    out = []
    if group is not None:
        group = np.asarray(group, dtype=np.int64)
        nq = len(group)
        q_order = rng.permutation(nq) if shuffle else np.arange(nq)
        starts = np.concatenate([[0], np.cumsum(group)])
        for qf in np.array_split(q_order, nfold):
            test_idx = (np.concatenate(
                [np.arange(starts[q], starts[q + 1]) for q in qf])
                if len(qf) else np.array([], dtype=np.int64))
            out.append(_with_train_rows(test_idx, num_data))
        return out
    if stratified:
        label = np.asarray(full_data.get_label())
        folds_idx = [[] for _ in range(nfold)]
        for c in np.unique(label):
            idxs = np.where(label == c)[0]
            if shuffle:
                rng.shuffle(idxs)
            for f, chunk in enumerate(np.array_split(idxs, nfold)):
                folds_idx[f].append(chunk)
        return [_with_train_rows(np.concatenate(f), num_data)
                for f in folds_idx]
    order = rng.permutation(num_data) if shuffle else np.arange(num_data)
    return [_with_train_rows(np.sort(test_idx), num_data)
            for test_idx in np.array_split(order, nfold)]


def _with_train_rows(test_idx: np.ndarray, num_data: int):
    """(the rows not in ``test_idx``, ascending; ``test_idx``)."""
    mask = np.ones(num_data, dtype=bool)
    mask[test_idx] = False
    return np.where(mask)[0], test_idx


def _agg_cv_result(raw_results):
    """Mean and standard deviation over the folds of every (data,
    metric) value (reference engine.py ``_agg_cv_result``)."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = "%s %s" % (one_line[0], one_line[1])
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True,
       metrics: Optional[Union[str, List[str]]] = None,
       feval=None, init_model=None,
       callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """Cross-validation (reference: engine.py:516): one Booster per fold
    on ``train_set.subset`` rows (the folds share its bin mappers), each
    evaluated on its held-out rows every iteration; returns
    ``{"valid <metric>-mean": [...], "valid <metric>-stdv": [...]}``
    (``train <metric>`` too with ``eval_train_metric``) and, with
    ``return_cvbooster``, the ``CVBooster`` under ``"cvbooster"``.
    Runs on ``params["device_type"]`` like ``train``; ``init_model``
    starts every fold from its trees, as in ``train``."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    fobj = _pop_callable_objective(params)
    cfg = Config.from_params(params)
    if cfg.objective not in ("binary", "multiclass", "multiclassova"):
        stratified = False
    merged = dict(params, **(train_set.params or {}))
    fobj = _pop_callable_objective(merged) or fobj
    train_set.params = merged
    train_set.construct()
    init_str = None if init_model is None else _model_text(init_model)
    cvbooster = CVBooster()
    for train_idx, test_idx in _make_n_folds(train_set, folds, nfold, params,
                                             cfg.seed, stratified, shuffle):
        bst = Booster(params=params, train_set=train_set.subset(train_idx))
        if init_str is not None:
            bst.inner.replay_init_model(
                Booster(params=params, model_str=init_str).inner.models)
        bst.add_valid(train_set.subset(test_idx), "valid")
        cvbooster.append(bst)

    callbacks_before, callbacks_after = _sorted_callbacks(cfg, callbacks)
    results = collections.defaultdict(list)
    for i in range(num_boost_round):
        for cb in callbacks_before:
            cb(callback_mod.CallbackEnv(
                model=cvbooster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        raw = []
        for bst in cvbooster.boosters:
            bst.update(fobj=fobj)
            one = bst.eval_train(feval) if eval_train_metric else []
            one.extend(bst.eval_valid(feval))
            raw.append(one)
        res = _agg_cv_result(raw)
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in callbacks_after:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=res))
        except callback_mod.EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for k in list(results.keys()):
                results[k] = results[k][:cvbooster.best_iteration]
            break
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
