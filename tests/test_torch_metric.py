"""The port's metrics against the JAX package's, on the CPU.

Every name and alias of the reference's ``_METRICS`` table, weighted and
unweighted, on the same labels and scores: the same metric names and
values within rtol 1e-12 (both packages evaluate in host NumPy). The
default metric of every objective resolves to the same names.
"""
import numpy as np
import pytest

import lightgbm_tpu.config as ref_config
import lightgbm_tpu.io.dataset as ref_dataset
import lightgbm_tpu.metric as ref_metric
import lightgbm_tpu.objective as ref_objective
import lightgbm_tpu_torch.config as port_config
import lightgbm_tpu_torch.io.dataset as port_dataset
import lightgbm_tpu_torch.metric as port_metric
import lightgbm_tpu_torch.objective as port_objective

REGRESSION = {"l1", "mean_absolute_error", "mae", "regression_l1", "l2",
              "mean_squared_error", "mse", "regression", "l2_root",
              "rmse", "root_mean_squared_error", "quantile", "huber",
              "fair", "mape", "mean_absolute_percentage_error"}
POSITIVE = {"poisson", "gamma", "gamma_deviance", "tweedie"}
BINARY = {"binary_logloss", "binary", "binary_error", "auc",
          "average_precision"}
MULTICLASS = {"auc_mu", "multi_logloss", "multiclass", "softmax",
              "multiclassova", "multi_error"}
RANK = {"ndcg", "lambdarank", "rank_xendcg", "map",
        "mean_average_precision"}
XENT = {"cross_entropy", "xentropy", "cross_entropy_lambda", "xentlambda",
        "kullback_leibler", "kldiv"}
ALL = REGRESSION | POSITIVE | BINARY | MULTICLASS | RANK | XENT

#: the objective whose convert_output a metric sees, per family
OBJECTIVE_OF = {"poisson": "poisson", "gamma": "gamma",
                "binary_logloss": "binary", "binary_error": "binary",
                "multi_logloss": "multiclass", "multi_error": "multiclass",
                "multiclassova": "multiclassova", "l2": "regression"}


def test_catalog_is_the_reference_catalog():
    assert set(ref_metric._METRICS) == ALL
    assert set(port_metric._METRICS) == ALL
    for name in ALL:
        assert (port_metric._METRICS[name].__name__
                == ref_metric._METRICS[name].__name__)


def _inputs(name, weighted, seed=0):
    rng = np.random.RandomState(seed)
    group, K, params = None, 1, {"verbose": -1}
    n = 4000
    if name in RANK:
        group = rng.randint(1, 40, size=120)
        n = int(group.sum())
        label = rng.randint(0, 5, n).astype(np.float64)
        label[:group[0]] = 0.0
        score = rng.randn(n)
        score[5:9] = 0.25
        params["eval_at"] = "1,3,5,10"
    elif name in MULTICLASS:
        K = 4
        label = rng.randint(0, K, n).astype(np.float64)
        score = rng.randn(n, K) * 2
        params.update(num_class=K, objective="multiclass",
                      multi_error_top_k=2 if name == "multi_error" else 1)
        if name == "auc_mu":
            params["auc_mu_weights"] = ",".join(
                str(v) for v in (rng.rand(K, K) * (1 - np.eye(K))).ravel())
    elif name in BINARY:
        label = (rng.rand(n) > 0.4).astype(np.float64)
        score = np.round(rng.randn(n) * 2, 1)          # ties
    elif name in XENT:
        label = rng.rand(n)
        label[:50] = 0.0
        label[50:100] = 1.0
        score = rng.randn(n) * 2
    elif name in POSITIVE:
        label = rng.gamma(2.0, 1.5, n)
        score = rng.gamma(2.0, 1.0, n)
    else:
        label = rng.randn(n) * 3
        score = rng.randn(n) * 3
        params.update(alpha=0.7, fair_c=0.8)
    weights = rng.rand(n) + 0.5 if weighted else None
    return params, label, weights, group, score


def _metrics(name, params, label, weights, group):
    n = len(label)
    out = []
    for cfg_mod, ds_mod, met_mod, extra in (
            (ref_config, ref_dataset, ref_metric, {}),
            (port_config, port_dataset, port_metric,
             {"device_type": "cpu"})):
        cfg = cfg_mod.Config.from_params(dict(params, **extra))
        md = ds_mod.Metadata(n)
        md.set_label(label)
        md.set_weights(weights)
        md.set_group(group)
        m = met_mod.create_metric(name, cfg)
        m.init(md, n)
        out.append((m, cfg))
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(ALL))
def test_metric_equals_reference(name, weighted):
    params, label, weights, group, score = _inputs(name, weighted)
    (rm, rcfg), (pm, pcfg) = _metrics(name, params, label, weights, group)
    assert pm.name == rm.name
    assert pm.factor_to_bigger_better == rm.factor_to_bigger_better
    objs = [(None, None)]
    if name in OBJECTIVE_OF:
        o = OBJECTIVE_OF[name]
        objs.append((ref_objective.create_objective(o, rcfg),
                     port_objective.create_objective(o, pcfg)))
    for robj, pobj in objs:
        want = rm.eval(score.copy(), robj)
        got = pm.eval(score.copy(), pobj)
        assert len(got) == len(want) == len(pm.name)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("objective", sorted(port_objective._OBJECTIVES))
def test_default_metric_of_every_objective(objective):
    params = {"objective": objective, "verbose": -1}
    if objective.startswith("multiclass"):
        params["num_class"] = 3
    rcfg = ref_config.Config.from_params(params)
    pcfg = port_config.Config.from_params(dict(params, device_type="cpu"))
    names = port_metric.resolve_metric_names(pcfg, pcfg.objective)
    assert names == ref_metric.resolve_metric_names(rcfg, rcfg.objective)
    for name in names:
        assert port_metric.create_metric(name, pcfg) is not None
    pcfg = port_config.Config.from_params(
        dict(params, device_type="cpu", metric="ndcg,l1,auc"))
    assert port_metric.resolve_metric_names(pcfg, pcfg.objective) == \
        ["ndcg", "l1", "auc"]
