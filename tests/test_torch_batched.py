"""Batched iterations and eval hoisting of the port (ROADMAP item 17)
against the port's own per-iteration loop and the JAX package, on the
CPU.

``tpu_batch_iterations=T`` runs T iterations through the learner's
``train_many`` (gradients, draws, roots and whole-tree steps with no host
read, one read of all T trees' records); ``tpu_eval_iterations=k``
evaluates on the absolute every-k grid. Levels (ROADMAP):

- port batched vs port looped: the reference's batched contract
  (tests/test_batched_training.py:36-55: structure and leaf counts
  exact, leaf values rtol 1e-5, gains rtol 1e-6 / atol 1e-4), and
  beyond it the same tree text and training score byte for byte (a):
  the batched update rounds ``f64(output) * shrinkage`` to f32 as the
  looped one does;
- port batched vs the JAX package's batched learner
  (``tree_learner="data", mesh_shape="data=1"``), both continuing one
  model text: the same splits and leaf counts in every batched tree,
  leaf values within rtol 1e-5 (1e-4 binary) (b);
- callbacks, early stopping, the eval grid and the eligibility gating:
  the reference's cases (tests/test_batched_training.py), the callback
  iterations equal to the JAX package's.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

import lightgbm_tpu as ref_lgb
from lightgbm_tpu.boosting import gbdt as ref_gbdt
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.boosting import gbdt as port_gbdt
from lightgbm_tpu_torch.treelearner import serial

torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
REF_LEARNER = {"tree_learner": "data", "mesh_shape": "data=1"}


def _xy(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10).astype(np.float32)
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.2 * rng.randn(n) > 0).astype(float)
    return X, y


def _make(extra=None, n=3000, seed=0, pkg=lgb):
    X, y = _xy(n, seed)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 31,
              "min_data_in_leaf": 20}
    params.update(CPU if pkg is lgb else REF_LEARNER)
    params.update(extra or {})
    return pkg.Booster(params=params, train_set=pkg.Dataset(X, label=y)), X


def _make_multiclass(objective="multiclass", extra=None, pkg=lgb):
    rng = np.random.RandomState(41)
    X = rng.randn(2500, 8).astype(np.float32)
    y = np.argmax(X[:, :3] + 0.25 * rng.randn(2500, 3), axis=1).astype(
        float)
    params = {"objective": objective, "num_class": 3, "verbosity": -1,
              "num_leaves": 15, "min_data_in_leaf": 30}
    params.update(CPU if pkg is lgb else REF_LEARNER)
    params.update(extra or {})
    return pkg.Booster(params=params, train_set=pkg.Dataset(X, label=y)), X


def _assert_contract(t1, t2, gain_rtol=1e-6):
    """The reference's batched contract
    (tests/test_batched_training.py:36-55)."""
    assert t1.num_leaves == t2.num_leaves
    ni = t1.num_internal
    for field in ("split_feature", "threshold_in_bin", "decision_type"):
        np.testing.assert_array_equal(getattr(t1, field)[:ni],
                                      getattr(t2, field)[:ni])
    np.testing.assert_array_equal(t1.leaf_count[:t1.num_leaves],
                                  t2.leaf_count[:t2.num_leaves])
    np.testing.assert_allclose(t1.leaf_value[:t1.num_leaves],
                               t2.leaf_value[:t2.num_leaves],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t1.split_gain[:ni], t2.split_gain[:ni],
                               rtol=gain_rtol, atol=1e-4)


def _texts(bst):
    return [t.to_string() for t in bst.inner.models]


_MODES = {
    "plain": {},
    "bag-freq1": {"bagging_fraction": 0.7, "bagging_freq": 1},
    "bag-freq2": {"bagging_fraction": 0.7, "bagging_freq": 2},
    "bag-balanced": {"bagging_fraction": 0.6, "bagging_freq": 1,
                     "pos_bagging_fraction": 0.9,
                     "neg_bagging_fraction": 0.4},
    "extra_trees": {"extra_trees": True},
    "goss": {"data_sample_strategy": "goss", "learning_rate": 0.3},
    "quantized8": {"use_quantized_grad": True, "quant_grad_bits": 8},
    "monotone-basic": {"monotone_constraints": [1, -1] + [0] * 8},
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_batched_matches_looped(mode):
    """Six batched iterations after the looped iteration 0 give the
    looped trees: the reference's contract, and the same text and
    training score bytes (a). One record read for the batch, no step
    counter read."""
    a, X = _make(_MODES[mode])
    b, _ = _make(_MODES[mode])
    a.update()
    b.update()
    assert a.inner.can_train_batched()
    reads = dict(a.inner.learner.grow_stats)
    assert a.inner.train_batch(6) is False
    for _ in range(6):
        b.update()
    assert len(a.inner.models) == len(b.inner.models) == 7
    for t1, t2 in zip(a.inner.models, b.inner.models):
        _assert_contract(t1, t2)
    assert _texts(a) == _texts(b)
    assert torch.equal(a.inner.train_score, b.inner.train_score)
    stats = a.inner.learner.grow_stats
    assert stats["record_reads"] - reads["record_reads"] == 1
    assert stats["flag_reads"] == reads["flag_reads"]
    assert stats["roots"] - reads["roots"] == 6
    # the maintained score is the sum of the host trees' outputs
    np.testing.assert_allclose(a.inner.train_score[:, 0].double().numpy(),
                               a.predict(X, raw_score=True), atol=1e-5)


@pytest.mark.parametrize("objective,extra", [
    ("multiclass", {}), ("multiclassova", {}),
    ("multiclass", {"bagging_fraction": 0.7, "bagging_freq": 1}),
], ids=["multiclass", "multiclassova", "multiclass-bagging"])
def test_multiclass_batched_matches_looped(objective, extra):
    """K trees per iteration from one gradient pass and one bag draw per
    iteration, as the looped path grows them."""
    a, X = _make_multiclass(objective, extra)
    b, _ = _make_multiclass(objective, extra)
    a.update()
    b.update()
    assert a.inner.can_train_batched()
    assert not a.inner.train_batch(4)
    for _ in range(4):
        b.update()
    assert len(a.inner.models) == len(b.inner.models) == 15
    for t1, t2 in zip(a.inner.models, b.inner.models):
        _assert_contract(t1, t2)
    assert _texts(a) == _texts(b)
    assert torch.equal(a.inner.train_score, b.inner.train_score)
    np.testing.assert_allclose(a.inner.train_score.double().numpy(),
                               a.predict(X, raw_score=True), atol=1e-5)


def _splits(tree):
    ni = tree.num_internal
    return list(zip(tree.split_feature[:ni].tolist(),
                    tree.threshold_in_bin[:ni].tolist(),
                    tree.left_child[:ni].tolist(),
                    tree.right_child[:ni].tolist()))


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("mode", ["plain", "bag-freq1", "quantized8",
                                  "extra_trees"])
def test_batched_port_vs_reference_batched(mode, objective, monkeypatch):
    """The port's batch against the JAX package's batched data learner
    on the same rows. Both continue one model text (the JAX package's
    looped tree 0, as ``init_model``) with six iterations in one batch,
    so every compared tree is a batched one, all grow from the same
    score, and the draws key on the same iteration numbers 0-5. Every
    batched tree has the same splits and leaf counts, and leaf values
    within rtol 1e-5 (b; 1e-4 for binary, the binary flow's tolerance of
    tests/test_torch_train.py, whose gradients differ by XLA's ``exp``).
    """
    value_rtol = 1e-5 if objective == "regression" else 1e-4
    extra = dict(_MODES[mode], objective=objective)
    r0, X = _make(extra, pkg=ref_lgb)
    r0.update()
    text = r0.model_to_string()
    _, y = _xy()
    batches, out = [], []
    for pkg, gbdt_cls in ((lgb, port_gbdt.GBDT),
                          (ref_lgb, ref_gbdt.GBDT)):
        real = gbdt_cls.train_batch

        def counted(self, n, real=real):
            batches.append(n)
            return real(self, n)
        monkeypatch.setattr(gbdt_cls, "train_batch", counted)
        params = {"objective": objective, "verbosity": -1,
                  "num_leaves": 31, "min_data_in_leaf": 20,
                  "tpu_batch_iterations": 6}
        params.update(CPU if pkg is lgb else REF_LEARNER)
        params.update(extra)
        out.append(pkg.train(params, pkg.Dataset(X, label=y),
                             num_boost_round=6,
                             init_model=pkg.Booster(model_str=text,
                                                    params=params)))
    a, r = out
    assert batches == [6, 6]
    assert len(a.inner.models) == len(r.inner.models) == 7
    assert a.inner.models[0].to_string() == r.inner.models[0].to_string()
    for t1, t2 in zip(r.inner.models[1:], a.inner.models[1:]):
        assert _splits(t1) == _splits(t2)
        np.testing.assert_array_equal(t1.leaf_count[:t1.num_leaves],
                                      t2.leaf_count[:t2.num_leaves])
        np.testing.assert_allclose(t2.leaf_value[:t2.num_leaves],
                                   t1.leaf_value[:t1.num_leaves],
                                   rtol=value_rtol, atol=1e-7)


_HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero",
               "aten::masked_select", "aten::is_nonzero", "aten::unique")


class _NoHostRead(TorchDispatchMode):
    """Records every op that reads a tensor back to the host (as in
    tests/test_torch_fused_growth.py)."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith(_HOST_READS) or (
                name.startswith(("aten::index.", "aten::index_put"))
                and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in (args[1] if len(args) > 1 else ())
                        if i is not None)):
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["plain", "bag-freq1", "goss",
                                  "quantized8", "extra_trees"])
def test_train_many_makes_no_host_read(monkeypatch, mode):
    """Gradients, draws, roots, steps, leaf outputs and score updates of
    a whole batch run with no host read (the histogram's plain CPU
    version trims its row list on the host, so it runs outside the
    recording mode; on the card the kernel reads the count there)."""
    a, _ = _make(dict(_MODES[mode], num_leaves=7))
    a.update()
    real = serial.build_histogram

    def hist(*args, **kwargs):
        with _disable_current_modes():
            return real(*args, **kwargs)
    monkeypatch.setattr(serial, "build_histogram", hist)
    inner = a.inner
    with _NoHostRead() as mode_:
        recs = inner.learner.train_many(
            inner.objective.get_gradients, inner.sample_strategy,
            inner.train_score, [1, 2, 3], inner.shrinkage_rate)
    assert mode_.reads == []
    assert tuple(recs.shape) == (3, 1, 6, 1 + inner.learner._record_width)


# ----------------------------------------------------------------------
# the engine: callbacks, early stopping, eval hoisting, best_score
# ----------------------------------------------------------------------
def _both(params, n_rounds, valid=None, seed=22, n=600, callbacks=None):
    """Train the port and the JAX package on the same rows; return each
    booster with the iterations its after-iteration callback saw."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] > 0).astype(float)
    Xv = rng.randn(200, 6)
    yv = (Xv[:, 0] > 0).astype(float)
    out = []
    for pkg, extra in ((lgb, CPU), (ref_lgb, REF_LEARNER)):
        seen = []

        def cb(env, seen=seen):
            seen.append((env.iteration, bool(env.evaluation_result_list)))
        tr = pkg.Dataset(X, label=y)
        vs = ([pkg.Dataset(Xv, label=yv, reference=tr)] if valid else None)
        bst = pkg.train(dict(params, **extra), tr, num_boost_round=n_rounds,
                        valid_sets=vs, callbacks=[cb] + list(callbacks or []))
        out.append((bst, seen))
    return out


def test_engine_batch_callbacks_at_batch_ends():
    """Iteration 0 looped, then full batches of 4; callbacks at batch
    ends with the batch's last index (reference
    test_engine_batch_callbacks_at_batch_boundaries)."""
    (port, seen), (ref, ref_seen) = _both(
        {"objective": "binary", "verbosity": -1, "num_leaves": 15,
         "tpu_batch_iterations": 4}, 9)
    assert [i for i, _ in seen] == [0, 4, 8]
    assert seen == ref_seen
    assert len(port.inner.models) == len(ref.inner.models) == 9
    looped = lgb.train({"objective": "binary", "verbosity": -1,
                        "num_leaves": 15, "device_type": "cpu"},
                       lgb.Dataset(*_rows(600, 22)), num_boost_round=9)
    assert port.model_to_string().replace(
        "[tpu_batch_iterations: 4]", "[tpu_batch_iterations: 0]") == \
        looped.model_to_string()


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    return X, (X[:, 0] > 0).astype(float)


def test_engine_batch_early_stopping():
    """Early stopping inside a batched run stops long before the last
    round at the looped run's best iteration (patience is counted in
    iterations, checked at batch ends)."""
    rng = np.random.RandomState(25)
    X = rng.randn(1500, 6)
    y = (X[:, 0] + 0.3 * rng.randn(1500) > 0).astype(float)
    Xv = rng.randn(400, 6)
    yv = (Xv[:, 0] + 0.3 * rng.randn(400) > 0).astype(float)
    out = []
    for batch in (5, 0):
        tr = lgb.Dataset(X, label=y)
        out.append(lgb.train(
            {"objective": "binary", "metric": "binary_logloss",
             "verbosity": -1, "num_leaves": 15, "device_type": "cpu",
             "tpu_batch_iterations": batch}, tr, num_boost_round=200,
            valid_sets=[lgb.Dataset(Xv, label=yv, reference=tr)],
            callbacks=[lgb.early_stopping(10, verbose=False)]))
    batched, looped = out
    assert 0 < batched.best_iteration < 200
    assert batched.current_iteration < 200
    assert batched.best_iteration == looped.best_iteration
    assert batched.best_score == looped.best_score


def test_eval_hoisting_fires_on_the_k_grid():
    """tpu_eval_iterations=3 over 8 rounds: callbacks at iterations 3, 6
    and the final 8 (indices 2, 5, 7), each with results, as the JAX
    package's."""
    (port, seen), (_, ref_seen) = _both(
        {"objective": "binary", "metric": "binary_logloss",
         "verbosity": -1, "num_leaves": 15, "tpu_eval_iterations": 3}, 8,
        valid=True, seed=51)
    assert seen == [(2, True), (5, True), (7, True)] == ref_seen
    assert len(port.inner.models) == 8
    assert "binary_logloss" in port.best_score["valid_0"]


def test_eval_hoisting_with_batched_loop():
    """Batches of 3 with the eval grid at 6 over 13 rounds: batch ends at
    1, 4, 7, 10, 13; evaluation where the count crosses a multiple of 6
    (7 and 13), as the JAX package's; the batched run's evaluations
    equal the looped run's at those iterations (the deferred valid
    walks flushed in order)."""
    params = {"objective": "binary", "metric": "binary_logloss",
              "verbosity": -1, "num_leaves": 15,
              "tpu_batch_iterations": 3, "tpu_eval_iterations": 6}
    (port, seen), (ref, ref_seen) = _both(params, 13, valid=True, seed=52,
                                          n=900)
    assert [i for i, _ in seen] == [6, 12] == [i for i, _ in ref_seen]
    assert len(port.inner.models) == 13
    rng = np.random.RandomState(52)
    X = rng.randn(900, 6)
    y = (X[:, 0] > 0).astype(float)
    Xv = rng.randn(200, 6)
    yv = (Xv[:, 0] > 0).astype(float)
    tr = lgb.Dataset(X, label=y)
    looped = lgb.train(dict(params, device_type="cpu",
                            tpu_batch_iterations=0, tpu_eval_iterations=0),
                       tr, num_boost_round=13,
                       valid_sets=[lgb.Dataset(Xv, label=yv, reference=tr)])
    assert port.best_score == looped.best_score
    np.testing.assert_allclose(port.best_score["valid_0"]["binary_logloss"],
                               ref.best_score["valid_0"]["binary_logloss"],
                               rtol=1e-5)


def test_engine_batch_best_score_without_early_stopping():
    """The final evaluation fills best_score and best_iteration with no
    early stopping, as the per-iteration loop does."""
    (port, _), (ref, _) = _both(
        {"objective": "binary", "metric": "binary_logloss",
         "verbosity": -1, "num_leaves": 15, "tpu_batch_iterations": 4}, 9,
        valid=True, seed=27, n=800)
    assert port.best_iteration == ref.best_iteration == 9
    np.testing.assert_allclose(port.best_score["valid_0"]["binary_logloss"],
                               ref.best_score["valid_0"]["binary_logloss"],
                               rtol=1e-5)


# ----------------------------------------------------------------------
# eligibility
# ----------------------------------------------------------------------
def _forced(tmp_path):
    path = tmp_path / "forced.json"
    path.write_text('{"feature": 1, "threshold": 0.0}')
    return {"forcedsplits_filename": str(path)}


@pytest.mark.parametrize("params", [
    {"feature_fraction": 0.5},
    {"feature_fraction_bynode": 0.5},
    {"objective": "quantile"},
    {"monotone_constraints": [1] + [0] * 5,
     "monotone_constraints_method": "intermediate"},
    {"cegb_penalty_split": 0.1},
    {"tpu_fused_tree": False},
    {"forced": True},
    {"boosting": "dart"},
    {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
    {"linear_tree": True},
    {"objective": "rank_xendcg"},
], ids=["ff", "bynode", "quantile", "intermediate", "cegb", "not_fused",
        "forced", "dart", "rf", "linear", "rank_xendcg"])
def test_eligibility_gating(params, tmp_path):
    """Each setting that needs host work per iteration declines the
    batch (reference test_eligibility_gating, test_serial_learner_not_
    batched, test_boosting_modes_not_batched, test_rank_xendcg_not_
    batched); ``lgb.train`` with ``tpu_batch_iterations`` then falls back
    to the per-iteration loop and gives as many trees as rounds, the
    looped run's trees."""
    if params.pop("forced", False):
        params.update(_forced(tmp_path))
    rng = np.random.RandomState(7)
    X = rng.randn(500, 6)
    y = (X[:, 0] > 0).astype(float)
    group = None
    if params.get("objective") == "rank_xendcg":
        y = rng.randint(0, 4, 500).astype(float)
        group = [10] * 50
    elif params.get("objective") == "quantile":
        y = X[:, 0] + 0.1 * rng.randn(500)
    p = dict({"objective": "binary", "verbosity": -1, "num_leaves": 15,
              "device_type": "cpu"}, **params)
    bst = lgb.Booster(params=p,
                      train_set=lgb.Dataset(X, label=y, group=group))
    bst.update()
    assert not bst.inner.can_train_batched()
    runs = [lgb.train(dict(p, tpu_batch_iterations=batch),
                      lgb.Dataset(X, label=y, group=group),
                      num_boost_round=6) for batch in (3, 0)]
    assert len(runs[0].inner.models) == 6
    assert [t.to_string() for t in runs[0].inner.models] == \
        [t.to_string() for t in runs[1].inner.models]


def test_custom_strategy_without_device_draw_declines():
    """A SampleStrategy subclass that overrides bagging() but not
    device_draw() must not batch: the inherited draw would replace its
    sampling (reference test_custom_strategy_without_traced_draw_
    declines_batching)."""
    from lightgbm_tpu_torch.boosting.sample_strategy import (
        BaggingStrategy, SampleStrategy)

    class HostOnly(SampleStrategy):
        def bagging(self, iter_idx, grad, hess):
            return grad, hess, torch.ones_like(grad)

    class Sub(BaggingStrategy):
        def bagging(self, iter_idx, grad, hess):
            return grad, hess, torch.ones_like(grad)

    bst, _ = _make()
    bst.update()
    assert bst.inner.can_train_batched()
    for cls in (HostOnly, Sub):
        bst.inner.sample_strategy = cls(bst.inner.config,
                                        bst.inner.num_data, bst.inner.device)
        assert not bst.inner.sample_strategy.supports_device_draw()
        assert not bst.inner.can_train_batched()
    assert BaggingStrategy.device_draw is not SampleStrategy.device_draw


def test_custom_objective_runs_looped():
    """A callable objective needs its gradients per iteration: the batch
    setting is ignored with a warning, and the looped trees come out."""
    X, y = _rows(600, 3)

    def fobj(preds, ds):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - ds.get_label(), p * (1.0 - p)
    runs = [lgb.train({"objective": fobj, "verbosity": -1, "num_leaves": 7,
                       "device_type": "cpu", "tpu_batch_iterations": b},
                      lgb.Dataset(X, label=y), num_boost_round=5)
            for b in (3, 0)]
    assert [t.to_string() for t in runs[0].inner.models] == \
        [t.to_string() for t in runs[1].inner.models]


# ----------------------------------------------------------------------
# quantized hand-off
# ----------------------------------------------------------------------
def test_quantized_batched_to_looped_recheck(monkeypatch):
    """8-bit: batched trees structure-exact to the looped ones; at the
    hand-off to the per-iteration loop (7 rounds, batches of 4: rounds
    5-6 looped) the scores are replayed once, and agree with the
    maintained score within 1e-3 x scale."""
    calls = []
    real = port_gbdt.GBDT.recheck_scores

    def spy(self, reason=""):
        calls.append(real(self, reason))
        return calls[-1]
    monkeypatch.setattr(port_gbdt.GBDT, "recheck_scores", spy)
    X, y = _xy(2000, 4)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 15,
              "use_quantized_grad": True, "quant_grad_bits": 8,
              "device_type": "cpu"}
    batched = lgb.train(dict(params, tpu_batch_iterations=4),
                        lgb.Dataset(X, label=y), num_boost_round=7)
    looped = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=7)
    assert len(calls) == 1
    scale = float(batched.inner.train_score.abs().max())
    assert calls[0] <= 1e-3 * max(scale, 1.0)
    assert len(batched.inner.models) == len(looped.inner.models) == 7
    for t1, t2 in zip(batched.inner.models, looped.inner.models):
        _assert_contract(t1, t2)
    assert torch.equal(batched.inner.train_score, looped.inner.train_score)


def test_stump_iteration_stops_the_batch():
    """An iteration that grows no tree stops training inside the batch:
    nothing of it or after it is kept, as the looped path stops."""
    rng = np.random.RandomState(5)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 4,
              "min_data_in_leaf": 140, "device_type": "cpu",
              "learning_rate": 1.0, "min_gain_to_split": 5.0}
    runs = [lgb.train(dict(params, tpu_batch_iterations=b),
                      lgb.Dataset(X, label=y), num_boost_round=9)
            for b in (4, 0)]
    assert runs[1].current_iteration < 9
    assert [t.to_string() for t in runs[0].inner.models] == \
        [t.to_string() for t in runs[1].inner.models]
    assert torch.equal(runs[0].inner.train_score, runs[1].inner.train_score)
