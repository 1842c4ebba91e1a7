"""Training entry point ``train``.

Port of the per-iteration loop of ``lightgbm_tpu/engine.py::train``
(API after the reference's python-package/lightgbm/engine.py:36), with
the reference's arguments in the reference's order: dataset
construction, validation sets aligned to the training bins, a callable
objective, ``feval``, ``init_model`` (continued training), evaluation and
the callbacks (``early_stopping`` is also armed by the
``early_stopping_round`` param). Checkpoints (``checkpoint_dir``,
``checkpoint_freq``, ``resume``) are ROADMAP item 19 and raise; batched
iterations are item 17.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import Config
from .utils.log import unsupported

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
    ``keep_training_booster`` says, as in the reference."""
    if checkpoint_dir is not None or checkpoint_freq > 0 or resume:
        unsupported("checkpoints (checkpoint_dir / checkpoint_freq / "
                    "resume)", "item 19")
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
    if init_model is not None:
        if isinstance(init_model, Booster):
            init_str = init_model.model_to_string()
        else:
            with open(init_model) as fh:
                init_str = fh.read()
        base = Booster(params=params, model_str=init_str)
        booster.inner.replay_init_model(base.inner.models)

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

    callbacks = list(callbacks or [])
    if cfg.early_stopping_round > 0 and not any(
            getattr(cb, "order", 0) == 30 for cb in callbacks):
        callbacks.append(callback_mod.early_stopping(
            cfg.early_stopping_round,
            first_metric_only=cfg.first_metric_only,
            verbose=cfg.verbosity >= 0))
    callbacks_before = sorted(
        (cb for cb in callbacks if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in callbacks
         if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    evaluation_result_list: List = []
    for i in range(num_boost_round):
        for cb in callbacks_before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        finished = booster.update(fobj=fobj)
        evaluation_result_list = []
        if eval_train:
            evaluation_result_list.extend(booster.eval_train(feval))
        evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in callbacks_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for item in (e.best_score or []):
                booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
            break
        if finished:
            break
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration
        for item in evaluation_result_list:
            booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    return booster
