"""Training callbacks.

Port of ``lightgbm_tpu/callback.py`` (API after the reference's
python-package/lightgbm/callback.py): ``CallbackEnv``,
``log_evaluation`` (:81), ``record_evaluation`` (:147),
``reset_parameter`` (:211) and ``early_stopping`` (:375, with min_delta
support).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Union

from .utils import log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    """reference: callback.py EarlyStopException."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return "%s's %s: %g" % (value[0], value[1], value[2])
    # cv case: (name, metric, mean, is_higher, stdv)
    if show_stdv:
        return "%s's %s: %g + %g" % (value[0], value[1], value[2], value[4])
    return "%s's %s: %g" % (value[0], value[1], value[2])


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """reference: callback.py:81."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            log.info("[%d]\t%s" % (env.iteration + 1, result))

    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    """reference: callback.py:147."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result[data_name][eval_name].append(result)

    _callback.order = 20
    return _callback


def reset_parameter(**kwargs: Union[list, Callable]) -> Callable:
    """reference: callback.py:211. Per-iteration parameter schedules: a
    list indexed by the iteration, or a callable of it; applied through
    ``Booster.reset_parameter`` before each iteration."""

    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        "Length of list %r should equal to "
                        "'num_boost_round'." % key)
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting "
                                 "round index to new parameter value.")
            new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True,
                   min_delta: Union[float, List[float]] = 0.0) -> Callable:
    """reference: callback.py:375 — stop when no eval metric improves
    (by at least ``min_delta``) in ``stopping_rounds`` rounds."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[Any] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            log.info("Training until validation scores don't improve for "
                     "%d rounds" % stopping_rounds)

        n_metrics = len({m[1] for m in env.evaluation_result_list})
        n_datasets = len(env.evaluation_result_list) // max(n_metrics, 1)
        if isinstance(min_delta, list):
            if not all(t >= 0 for t in min_delta):
                raise ValueError(
                    "Values for early stopping min_delta must be "
                    "non-negative.")
            if len(min_delta) == 0:
                deltas = [0.0] * n_datasets * n_metrics
            elif len(min_delta) == 1:
                deltas = min_delta * n_datasets * n_metrics
            else:
                if len(min_delta) != n_metrics:
                    raise ValueError(
                        "Must provide a single value for min_delta or as "
                        "many as metrics.")
                if first_metric_only and verbose:
                    log.info("Using only %s for early stopping"
                             % str(min_delta[0]))
                deltas = min_delta * n_datasets
        else:
            if min_delta < 0:
                raise ValueError(
                    "Early stopping min_delta must be non-negative.")
            if min_delta > 0 and n_metrics > 1 and not first_metric_only \
                    and verbose:
                log.info("Using %s as min_delta for all metrics."
                         % str(min_delta))
            deltas = [min_delta] * n_datasets * n_metrics

        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret, delta in zip(env.evaluation_result_list, deltas):
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # is_higher_better
                best_score.append(float("-inf"))
                cmp_op.append(
                    lambda cur, best, d=delta: cur > best + d)
            else:
                best_score.append(float("inf"))
                cmp_op.append(
                    lambda cur, best, d=delta: cur < best - d)

    def _final_iteration_check(env, eval_name_splitted, i) -> None:
        if env.iteration == env.end_iteration - 1:
            if verbose:
                log.info("Did not meet early stopping. Best iteration is:"
                         "\n[%d]\t%s" % (
                             best_iter[i] + 1, "\t".join(
                                 _format_eval_result(x)
                                 for x in best_score_list[i])))
                if first_metric_only:
                    log.info("Evaluated only: %s" % eval_name_splitted[-1])
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = \
                env.evaluation_result_list[i][1].split(" ")
            if first_metric_only and first_metric[0] != \
                    eval_name_splitted[-1]:
                continue
            if env.evaluation_result_list[i][0] == "training":
                _final_iteration_check(env, eval_name_splitted, i)
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info("Early stopping, best iteration is:\n[%d]\t%s"
                             % (best_iter[i] + 1, "\t".join(
                                 _format_eval_result(x)
                                 for x in best_score_list[i])))
                    if first_metric_only:
                        log.info("Evaluated only: %s"
                                 % eval_name_splitted[-1])
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)

    _callback.order = 30
    return _callback
