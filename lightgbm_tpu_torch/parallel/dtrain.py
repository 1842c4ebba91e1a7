"""Multi-process distributed training entry point.

Port of ``lightgbm_tpu/parallel/dtrain.py`` (the analogue of the
reference's Dask integration, python-package/lightgbm/dask.py:172
``_train_part``: one training task per worker, each holding a row shard,
every worker ending with the same model).

Every rank calls :func:`train` with its LOCAL rows after
``parallel.distributed.initialize``. Binning, histogram sums and split
decisions are synchronized across the ranks
(``distributed_binned_dataset``, ``DistributedDataParallelLearner``),
so every rank grows the same trees and returns the same ``Booster``.
Gradients and scores stay local: each rank runs the port's own GBDT
loop (``boosting/gbdt.py``) over its rows, with the boost-from-average
score taken from label sums over all ranks. Training metrics that are
sums over rows are reduced exactly; the AUC / ranking family is a
per-rank approximation, labelled so in the log.

Usage (per process)::

    from lightgbm_tpu_torch.parallel import distributed, dtrain
    distributed.initialize("file:///tmp/rdv", num_processes=2,
                           process_id=rank, backend="gloo")
    booster = dtrain.train({"objective": "binary", "num_leaves": 31},
                           local_X, local_y, num_boost_round=100)

A rank whose peer never joins a collective does not hang: the group's
timeout (``initialize``) bounds the histogram all-reduces, and
:func:`run_collective` bounds the host collectives with a fatal,
flushed ``dtrain_peer_timeout`` health event.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..basic import Booster
from ..boosting.gbdt import GBDT, kEpsilon
from ..config import Config, drop_param
from ..metric import create_metric
from ..obs import events as obs_events
from ..obs import health as obs_health
from ..obs import trace as obs_trace
from ..obs.registry import registry as obs
from ..utils import log
from . import distributed as D

_ENV_COLLECTIVE_TIMEOUT = "LIGHTGBM_TPU_DTRAIN_TIMEOUT_S"
kDefaultCollectiveTimeoutS = 300.0


def collective_timeout() -> float:
    """Seconds one cross-process collective may block (<= 0 disables
    the bound)."""
    try:
        return float(os.environ.get(_ENV_COLLECTIVE_TIMEOUT,
                                    kDefaultCollectiveTimeoutS))
    except ValueError:
        return kDefaultCollectiveTimeoutS


def run_collective(fn, what: str = "allreduce",
                   timeout: Optional[float] = None):
    """Run a blocking cross-process collective with peer-death detection
    (reference ``run_collective``, :58): the call runs on a watcher-owned
    daemon thread, and a peer that never shows up turns into a fatal
    ``health`` event (flushed) and ``LightGBMError`` after the timeout
    (``LIGHTGBM_TPU_DTRAIN_TIMEOUT_S``, default 300 s; <= 0 runs
    unbounded) instead of a rank blocked forever."""
    if timeout is None:
        timeout = collective_timeout()
    if timeout <= 0:
        return fn()
    out: list = []
    err: list = []

    def _run():
        try:
            out.append(fn())
        except BaseException as e:  # surfaced on the caller thread
            err.append(e)

    t = threading.Thread(target=_run, daemon=True,
                         name="dtrain-collective")
    t.start()
    t.join(timeout)
    if t.is_alive():
        rank = D.rank() if dist.is_initialized() else -1
        obs.inc("health/dtrain_peer_timeout")
        obs_events.emit("health", rule="dtrain_peer_timeout",
                        severity="fatal", what=what, rank=rank,
                        value=timeout, threshold=timeout,
                        detail="collective %r did not complete; a peer "
                               "rank is likely dead" % what)
        obs_events.flush()
        log.fatal("distributed collective %r did not complete within "
                  "%.0f s (%s) — a peer rank is likely dead or "
                  "partitioned; aborting this rank instead of hanging"
                  % (what, timeout, _ENV_COLLECTIVE_TIMEOUT))
    if err:
        raise err[0]
    return out[0]


def _allreduce_sum(vals: Sequence[float]) -> np.ndarray:
    """Sums across the ranks in f64 on CPU tensors (reference
    ``_allreduce_sum``, :108; Network::GlobalSyncUpBySum), bounded by
    :func:`run_collective`."""
    obs.inc("dtrain/allreduce_sum")
    t = torch.tensor(list(vals), dtype=torch.float64)

    def _reduce():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=D.host_group())
        return t
    return run_collective(_reduce, what="allreduce_sum").numpy()


def _global_init_scores(objective, config: Config, label: np.ndarray,
                        weight: Optional[np.ndarray], K: int) -> List[float]:
    """boost_from_average over every rank's labels (reference :245-285):
    the port's objectives' own formulas over all-reduced sums, so every
    rank starts from one score. Percentile objectives have no such sums:
    each rank keeps its own (a warning says so)."""
    scores = [0.0] * K
    if not config.boost_from_average or objective is None:
        return scores
    name = objective.name
    w = (np.ones(len(label)) if weight is None
         else np.asarray(weight, dtype=np.float64))
    eps = 1e-15
    if name in ("binary", "multiclassova"):
        classes = ([(label > 0)] if name == "binary"
                   else [label.astype(np.int64) == k for k in range(K)])
        if weight is None:
            tot = _allreduce_sum([float(c.sum()) for c in classes]
                                 + [float(len(label))])
        else:
            tot = _allreduce_sum([float((c * w).sum()) for c in classes]
                                 + [float(w.sum())])
        sig = float(config.sigmoid)
        for k in range(len(classes)):
            p = min(max(tot[k] / tot[-1], eps), 1.0 - eps)
            scores[k] = float(np.log(p / (1.0 - p)) / sig)
    elif name in ("regression", "huber", "poisson", "gamma", "tweedie"):
        tot = _allreduce_sum([float((label * w).sum()), float(w.sum())])
        mean = tot[0] / tot[1]
        scores[0] = (float(mean) if name in ("regression", "huber")
                     else float(np.log(max(mean, 1e-20))))
    elif name in ("regression_l1", "quantile", "mape"):
        scores[0] = float(objective.boost_from_score(0))
        log.warning("%s boost_from_average uses this rank's percentile; "
                    "the init score is approximate" % name)
    else:
        scores = [float(objective.boost_from_score(k)) for k in range(K)]
    return scores


class _DistributedGBDT(GBDT):
    """The port's GBDT over this rank's rows with the distributed
    learner and the ranks' common init score."""

    def __init__(self, config: Config, train_data, device: torch.device,
                 init_scores: List[float]):
        self._global_init = init_scores
        super().__init__(config, train_data, device)

    def _make_learner(self, config, train_data):
        return D.DistributedDataParallelLearner(config, train_data,
                                                self.device)

    def _boost_from_average(self, class_id: int) -> float:
        if self.models or self._has_init_score or self.objective is None:
            return 0.0
        init = self._global_init[class_id]
        if self.config.boost_from_average and abs(init) > kEpsilon:
            self._add_const_score(init, class_id)
            log.info("Start training from score %f" % init)
            return init
        return 0.0


def _check_classes(config: Config, label: np.ndarray) -> None:
    """Every rank must hold every class of a binary or multiclass
    objective (per-class state derives from local labels). Collective:
    every rank gathers every rank's coverage and they fail together."""
    obj = str(config.objective)
    if obj != "binary" and not obj.startswith("multiclass"):
        return
    expected = (list(range(max(int(config.num_class), 2)))
                if obj.startswith("multiclass") else [0, 1])
    present = set(np.unique((label > 0).astype(np.int64) if obj == "binary"
                            else label.astype(np.int64)))
    mask = torch.tensor([1.0 if k in present else 0.0 for k in expected],
                        dtype=torch.float32)
    masks = run_collective(lambda: D.all_gather_host(mask),
                           what="class_coverage_allgather")
    bad = {r: [expected[k] for k in range(len(expected)) if m[k] == 0.0]
           for r, m in enumerate(masks) if bool((m == 0.0).any())}
    if bad:
        log.fatal("shards are missing classes (rank -> classes): %s; "
                  "distributed training needs every class on every shard"
                  % bad)


def train(params: Dict, local_X: np.ndarray, local_y: np.ndarray,
          num_boost_round: int = 100,
          local_weight: Optional[np.ndarray] = None,
          local_group: Optional[np.ndarray] = None) -> Booster:
    """Distributed GBDT boosting over per-rank row shards (reference
    ``train``, :124). Returns a Booster, the same on every rank. The
    learner runs on ``device_type`` (the card by default), on the
    rank's card of ``distributed.rank_device``: a card of its own under
    NCCL, ``gpu_device_id``'s card under gloo."""
    if not dist.is_initialized():
        log.fatal("dtrain.train needs an initialized process group "
                  "(parallel.distributed.initialize)")
    # the process group is the set of machines; num_machines is read by
    # the CLI (application.py), which calls this function in each rank
    params = drop_param(params, "num_machines")
    config = Config.from_params(params)
    if config.boosting != "gbdt":
        # the JAX package's dtrain boosts gbdt whatever boosting says
        log.fatal("boosting=%s: distributed training boosts gbdt trees "
                  "only; train DART or RF in one process, over several "
                  "cards with tree_learner and mesh_shape"
                  % config.boosting)
    if config.is_unbalance:
        log.fatal("is_unbalance in distributed training: its class weights "
                  "would come from each rank's own label counts, so the "
                  "ranks would boost different gradients; set "
                  "scale_pos_weight from the global counts instead")
    rank = D.rank()
    device = D.rank_device(config)
    # the rank of every trace event and gateway push of this process
    obs_trace.set_process_index(rank)
    if obs_trace.active() and obs_trace.stream_dir() is None:
        # one trace file per rank, pid = the rank (reference :156-170)
        obs_trace.configure(obs_trace.rank_path(obs_trace.sink_path(), rank),
                            process_index_override=rank, keep_buffer=True)
    obs_health.record_backend_once(source="dtrain")
    obs_trace.sample_iteration(0)
    local_X = np.asarray(local_X, dtype=np.float64)
    local_y = np.asarray(local_y, dtype=np.float64)
    n_local = local_X.shape[0]
    with obs.scope("io::distributed_binning"):
        ds = D.distributed_binned_dataset(local_X, config, label=local_y,
                                          weights=local_weight,
                                          group=local_group)
    _check_classes(config, local_y)
    from ..objective import create_objective
    objective = create_objective(config.objective, config)
    objective.init(ds.metadata, n_local)
    K = max(int(objective.num_model_per_iteration), 1)
    init_scores = _global_init_scores(objective, config, local_y,
                                      local_weight, K)
    gbdt = _DistributedGBDT(config, ds, device, init_scores)
    for it in range(num_boost_round):
        if gbdt.train_one_iter():
            break
        if (config.metric and config.is_provide_training_metric
                and (it + 1) % max(config.metric_freq, 1) == 0):
            _log_metrics(gbdt, config, ds, it + 1)
    if obs_events.enabled():
        # the rank's summary, for callers that see only its event log
        # (the CLI's ranks): what its learner ran
        from ..ops.histogram import device_launch_counts
        st, cs = gbdt.learner.grow_stats, gbdt.learner.comm_stats
        obs_events.emit("dtrain_done", rank=rank, trees=len(gbdt.models),
                        roots=st["roots"], steps=st["steps"],
                        captures=st["captures"],
                        allreduces=cs["allreduces"],
                        launches=device_launch_counts())
    return Booster(params=dict(params), model_str=gbdt.save_model_to_string())


def _log_metrics(gbdt: GBDT, config: Config, ds, it: int) -> None:
    """Training metrics over every rank (reference :300-325): a rank's
    mean times its rows, summed, over the total rows."""
    K = gbdt.num_tree_per_iteration
    score = gbdt.train_score.cpu().numpy().astype(np.float64)
    n_local = ds.num_data
    for name in config.metric:
        m = create_metric(name, config)
        if m is None:
            continue
        m.init(ds.metadata, n_local)
        local = m.eval(score[:, 0] if K == 1 else score, gbdt.objective)
        red = _allreduce_sum([local[0] * n_local, float(n_local)])
        canon = m.name[0] if isinstance(m.name, (list, tuple)) else m.name
        approx = str(canon).startswith(("auc", "ndcg", "map",
                                        "average_precision"))
        log.info("[%d] %s %s: %.6f" % (it, "rank-avg approx" if approx
                                       else "global", name,
                                       red[0] / red[1]))
