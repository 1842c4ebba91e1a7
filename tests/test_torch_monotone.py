"""Monotone constraints of the port against the JAX package's, on the CPU:
the basic, intermediate and advanced methods and ``monotone_penalty``.

- The scan under output bounds, with the depth penalty and with the
  advanced method's per-bin bound arrays picks the reference's winner;
  its gain, outputs, sums and the four child bounds are bit-equal
  (level a, as tests/test_torch_split.py holds the plain scan).
- The intermediate and advanced trackers, driven through the same split
  sequence on one tree, give the reference trackers' child bounds,
  leaves to update, entries and bound arrays (level a).
- Trees of every method, in f32 and with 8-bit gradients, make the
  reference's splits, thresholds and leaf counts, leaf values within
  1e-4 (level b).
- Predictions are monotone in each constrained column over a grid.
- CEGB, forced splits, interaction constraints and extra_trees warn as
  the reference orders them; a renewing objective is fatal.
- The basic method's whole-tree loop gives the per-split loop's trees,
  text for text.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu.config as ref_config
import lightgbm_tpu_torch as lgb
import lightgbm_tpu_torch.config as port_config
from lightgbm_tpu.ops import split as ref_split
from lightgbm_tpu.treelearner import monotone as ref_monotone
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.ops import split as S
from lightgbm_tpu_torch.ops.histogram import build_histogram
from lightgbm_tpu_torch.treelearner import monotone
from lightgbm_tpu_torch.utils import log
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

BASE = {"objective": "regression", "num_leaves": 15, "verbose": -1}
MC = [1, -1, 0, 1, 0, 0]


def _data(n=1500, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.08, 4] = np.nan
    y = (X[:, 0] + np.sin(3 * X[:, 1]) - 0.5 * X[:, 2] + 0.7 * X[:, 3] ** 2
         + 0.3 * X[:, 5] + 0.1 * rng.randn(n))
    return X, y


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


def _train_both(extra, rounds=3):
    X, y = _data()
    params = dict(BASE, monotone_constraints=MC, **extra)
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=rounds)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=rounds)
    return ref, port


def _assert_level_b(ref, port):
    assert len(ref.inner.models) == len(port.inner.models)
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------------
# the scan
# ----------------------------------------------------------------------
F, B = 8, 64
MONO = np.array([1, -1, 0, 1, -1, 0, 1, 0], dtype=np.int32)


def _case(seed, missing):
    rng = np.random.RandomState(seed)
    n = 4000
    num_bin = rng.randint(3, B + 1, size=F).astype(np.int32)
    bins = np.stack([rng.randint(0, nb, size=n) for nb in num_bin],
                    axis=1).astype(np.uint8)
    zero_bin = np.array([rng.randint(0, nb) for nb in num_bin],
                        dtype=np.int32)
    missing_type = np.full(F, missing, dtype=np.int32)
    # a gradient that rises with the bins of the first features, so the
    # unconstrained winner breaks some constraints
    g = (rng.randn(n) + 0.05 * bins[:, 0] - 0.05 * bins[:, 1]
         + 0.04 * bins[:, 3]).astype(np.float32)
    gh = np.stack([g, rng.rand(n) + 0.05, np.ones(n), np.ones(n)],
                  axis=1).astype(np.float32)
    hist = build_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B)
    sums = gh.sum(axis=0, dtype=np.float32)
    arrays = None
    if seed % 2:
        at = float(-gh[:, 0].sum() / gh[:, 1].sum())
        lo = np.where(rng.rand(F, B) < 0.2, at - 0.3 + rng.randn(F, B) * 0.1,
                      -np.inf)
        hi = np.where(rng.rand(F, B) < 0.2, at + 0.3 + rng.randn(F, B) * 0.1,
                      np.inf)
        pad = np.arange(B)[None, :] >= num_bin[:, None]
        arrays = (np.where(pad, -np.inf, lo).astype(np.float32),
                  np.where(pad, np.inf, hi).astype(np.float32))
    return hist, sums, num_bin, missing_type, zero_bin, arrays


# bounds as offsets from the leaf's own output
SCANS = {
    "bounds": dict(bounds=(-0.2, 0.3)),
    "one_sided": dict(bounds=(-np.inf, 0.1)),
    "penalty": dict(params={"monotone_penalty": 2.0}, depth=1),
    "penalty_deep": dict(params={"monotone_penalty": 0.5}, depth=3,
                         bounds=(-0.5, 0.5)),
    "bound_arrays": dict(arrays=True, depth=2),
    "smooth_l1": dict(params={"path_smooth": 2.0, "lambda_l1": 0.3},
                      bounds=(-0.4, 0.2)),
}


def _bits(v):
    return int(np.asarray(v, dtype=np.float32).view(np.int32))


@pytest.mark.parametrize("missing", [0, 2])
@pytest.mark.parametrize("case", sorted(SCANS))
def test_monotone_scan_equals_reference(case, missing):
    spec = SCANS[case]
    seed = 11 + missing + (1 if spec.get("arrays") else 0)
    hist, sums, num_bin, missing_type, zero_bin, arrays = _case(seed,
                                                               missing)
    params = dict(spec.get("params", {}), verbose=-1)
    rp = ref_split.SplitParams.from_config(
        ref_config.Config.from_params(params))
    pp = S.SplitParams.from_config(
        port_config.Config.from_params(dict(params, device_type="cpu")),
        torch.device("cpu"))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    parent = S.calculate_leaf_output(f32(sums[0]), f32(sums[1]), pp)
    lo, hi = (None if d is None else float(np.float32(float(parent) + d))
              for d in spec.get("bounds", (None, None)))
    depth = spec.get("depth")
    mask = np.ones(F, dtype=bool)
    rmeta = ref_split.FeatureMeta(
        num_bin=jnp.asarray(num_bin), missing_type=jnp.asarray(missing_type),
        zero_bin=jnp.asarray(zero_bin),
        is_categorical=jnp.zeros(F, dtype=bool),
        use_onehot=jnp.zeros(F, dtype=bool),
        monotone=jnp.asarray(MONO.astype(np.int8)))
    ref = ref_split.find_best_split(
        jnp.asarray(hist.numpy()), *[jnp.float32(v) for v in sums], rmeta,
        rp, jnp.asarray(mask),
        None if lo is None else jnp.float32(lo),
        None if hi is None else jnp.float32(hi),
        parent_output=jnp.float32(float(parent)),
        leaf_depth=None if depth is None else jnp.int32(depth),
        has_categorical=False,
        bound_arrays=(None if arrays is None
                      else tuple(jnp.asarray(a) for a in arrays)))
    pmeta = S.FeatureMeta(num_bin=torch.from_numpy(num_bin),
                          missing_type=torch.from_numpy(missing_type),
                          zero_bin=torch.from_numpy(zero_bin),
                          monotone=torch.from_numpy(MONO))
    got = S.find_best_split(
        hist, *[f32(v) for v in sums], pmeta, pp, torch.from_numpy(mask),
        parent, has_monotone=True,
        min_output=None if lo is None else f32(lo),
        max_output=None if hi is None else f32(hi),
        leaf_depth=None if depth is None else f32(depth),
        bound_arrays=(None if arrays is None
                      else tuple(torch.from_numpy(a) for a in arrays)))
    assert got.shape == (S.record_width(B, False, True),)
    got = got.tolist()
    assert int(ref.feature) >= 0, "the case must have a valid split"
    assert int(got[S.FEATURE]) == int(ref.feature)
    assert int(got[S.THRESHOLD_BIN]) == int(ref.threshold_bin)
    assert bool(got[S.DEFAULT_LEFT]) == bool(ref.default_left)
    at = S.RecordLayout(B, False, True).bounds
    for col, val in ((S.GAIN, ref.gain), (S.LEFT_OUTPUT, ref.left_output),
                     (S.RIGHT_OUTPUT, ref.right_output),
                     (S.LEFT_SUM_GRAD, ref.left_sum_grad),
                     (S.RIGHT_SUM_HESS, ref.right_sum_hess),
                     (at + S.LEFT_MIN, ref.left_min_output),
                     (at + S.LEFT_MAX, ref.left_max_output),
                     (at + S.RIGHT_MIN, ref.right_min_output),
                     (at + S.RIGHT_MAX, ref.right_max_output)):
        assert _bits(got[col]) == _bits(val), (col, got[col], float(val))


def test_constraints_change_the_scan_winner():
    """The cases above are not vacuous: without the constraints the
    bounds case picks another split or other outputs."""
    hist, sums, num_bin, missing_type, zero_bin, _ = _case(11, 0)
    pp = S.SplitParams.from_config(
        port_config.Config.from_params({"device_type": "cpu"}),
        torch.device("cpu"))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    parent = S.calculate_leaf_output(f32(sums[0]), f32(sums[1]), pp)
    meta = S.FeatureMeta(num_bin=torch.from_numpy(num_bin),
                         missing_type=torch.from_numpy(missing_type),
                         zero_bin=torch.from_numpy(zero_bin),
                         monotone=torch.from_numpy(MONO))
    args = (hist, *[f32(v) for v in sums], meta, pp,
            torch.ones(F, dtype=torch.bool), parent)
    plain = S.find_best_split(*args).tolist()
    lo, hi = float(parent) - 0.2, float(parent) + 0.3
    bounded = S.find_best_split(*args, has_monotone=True,
                                min_output=f32(lo),
                                max_output=f32(hi)).tolist()
    assert plain[:S.RECORD_WIDTH] != bounded[:S.RECORD_WIDTH]
    assert lo - 1e-6 <= bounded[S.LEFT_OUTPUT] <= hi + 1e-6


# ----------------------------------------------------------------------
# the trackers
# ----------------------------------------------------------------------
def _drive_trackers(method, seed, L=24):
    """Grow one random tree of L leaves, driving the reference's and the
    port's tracker with the same calls; both must agree after each
    split."""
    rng = np.random.RandomState(seed)
    Fp = 8
    mono = np.array([1, -1, 0, 1, 0, -1, 0, 0], dtype=np.int8)
    num_bin = rng.randint(4, 40, size=Fp).astype(np.int64)
    Bt = 64
    if method == "advanced":
        ref_t = ref_monotone.AdvancedMonotoneTracker(L, mono, num_bin, Bt)
        port_t = monotone.AdvancedMonotoneTracker(L, mono, num_bin, Bt)
    else:
        ref_t = ref_monotone.IntermediateMonotoneTracker(L, mono)
        port_t = monotone.IntermediateMonotoneTracker(L, mono)
    tree = Tree(L)
    for k in range(1, L):
        leaf = int(rng.randint(0, tree.num_leaves))
        f = int(rng.randint(0, Fp))
        tbin = int(rng.randint(0, num_bin[f] - 1))
        lo, ro = (float(np.float32(v)) for v in rng.randn(2) * 0.1)
        for t in (ref_t, port_t):
            t.before_split(tree, leaf, int(mono[f]))
        tree.split(leaf=leaf, feature=f, feature_inner=f, threshold_bin=tbin,
                   threshold_real=float(tbin), left_value=lo,
                   right_value=ro, left_count=10, right_count=10,
                   left_weight=1.0, right_weight=1.0, gain=1.0,
                   missing_type=0, default_left=False)
        if method == "advanced":
            for t in (ref_t, port_t):
                t.apply_split_outputs(leaf, k, int(mono[f]), lo, ro, True)
        else:
            got = [t.child_bounds(leaf, int(mono[f]), lo, ro)
                   for t in (ref_t, port_t)]
            assert got[0] == got[1]
            for t in (ref_t, port_t):
                t.apply_split(tree, leaf, k, got[0])
        live = rng.rand(L) < 0.8
        upd = [t.leaves_to_update(tree, k, f, tbin, lo, ro, True,
                                  lambda l: l <= k and live[l])
               for t in (ref_t, port_t)]
        assert upd[0] == upd[1], k
        assert ref_t.entries == port_t.entries
        if method == "advanced":
            for leaf_ in range(tree.num_leaves):
                a = ref_t.leaf_bound_arrays(tree, leaf_)
                b = port_t.leaf_bound_arrays(tree, leaf_)
                assert np.array_equal(a[0], b[0]) and np.array_equal(a[1],
                                                                     b[1])
    return port_t


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trackers_equal_reference(method, seed):
    t = _drive_trackers(method, seed)
    # the walk did tighten bounds somewhere
    if method == "intermediate":
        assert any(np.isfinite(lo) or np.isfinite(hi)
                   for lo, hi in t.entries)
    else:
        assert np.isfinite(t.min_c).any() or np.isfinite(t.max_c).any()


# ----------------------------------------------------------------------
# trees against the reference
# ----------------------------------------------------------------------
TREE_CASES = {
    "basic": {},
    "basic_8bit": {"use_quantized_grad": True},
    "intermediate": {"monotone_constraints_method": "intermediate"},
    "intermediate_8bit": {"monotone_constraints_method": "intermediate",
                          "use_quantized_grad": True},
    "advanced": {"monotone_constraints_method": "advanced"},
    "advanced_8bit": {"monotone_constraints_method": "advanced",
                      "use_quantized_grad": True},
    "penalty": {"monotone_penalty": 2.0},
    "basic_per_split_max_depth": {"tpu_fused_tree": False,
                                  "max_depth": 4},
    "basic_cegb": {"cegb_penalty_split": 0.001},
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_trees_match_reference(case):
    ref, port = _train_both(TREE_CASES[case])
    _assert_level_b(ref, port)
    stats = port.inner.learner.grow_stats
    if "intermediate" in case or "advanced" in case:
        assert port.inner.learner._mono_tracker is not None
        assert stats["rescans"] > 0
        splits = sum(t.num_leaves - 1 for t in port.inner.models)
        assert splits <= stats["split_reads"] <= 2 * splits + 3
    assert "monotone_constraints=1 -1 0 1 0 0" in port.model_to_string()


def _grid_monotone(booster, X, column, sign, points=32):
    lo, hi = np.nanpercentile(X[:, column], [1, 99])
    grid = np.linspace(lo, hi, points)
    rows = X[:50]
    preds = []
    for v in grid:
        Xg = rows.copy()
        Xg[:, column] = v
        preds.append(booster.predict(Xg))
    d = np.diff(np.stack(preds), axis=0) * sign
    return bool((d >= -1e-12).all())


@pytest.mark.parametrize("method", ["basic", "intermediate", "advanced"])
def test_predictions_are_monotone(method):
    X, y = _data()
    bst = lgb.train(dict(BASE, device_type="cpu", monotone_constraints=MC,
                         monotone_constraints_method=method,
                         num_leaves=31), lgb.Dataset(X, label=y),
                    num_boost_round=5)
    for col, sign in enumerate(MC):
        if sign:
            assert _grid_monotone(bst, X, col, sign), (method, col)
    free = lgb.train(dict(BASE, device_type="cpu", num_leaves=31),
                     lgb.Dataset(X, label=y), num_boost_round=5)
    assert not _grid_monotone(free, X, 1, -1)


def _warnings(monkeypatch):
    warned = []
    monkeypatch.setattr(log, "warning",
                        lambda msg, *a: warned.append(msg % a if a else msg))
    return warned


@pytest.mark.parametrize("extra,match", [
    ({"cegb_penalty_split": 0.01}, "CEGB takes precedence"),
    ({"forcedsplits_filename": "FORCED"}, "forced splits are ignored"),
    ({"interaction_constraints": [[0, 1], [2, 3, 4, 5]]},
     "interaction constraints are ignored"),
    ({"extra_trees": True}, "extra_trees is ignored"),
], ids=["cegb", "forced", "interaction_constraints", "extra_trees"])
def test_precedence_warnings(monkeypatch, tmp_path, extra, match):
    if "forcedsplits_filename" in extra:
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
        extra = {"forcedsplits_filename": str(path)}
    warned = _warnings(monkeypatch)
    ref, port = _train_both(dict(extra,
                                 monotone_constraints_method="intermediate"),
                            rounds=2)
    assert any(match in m for m in warned)
    learner = port.inner.learner
    cegb = "cegb_penalty_split" in extra
    assert (learner._mono_tracker is None) == cegb
    if not cegb:
        assert not learner._draws_thresholds()
    _assert_level_b(ref, port)


def test_renewing_objective_is_fatal():
    X, y = _data(n=300)
    for pkg in (ref_lgb, lgb):
        params = dict(BASE, objective="regression_l1",
                      monotone_constraints=MC)
        if pkg is lgb:
            params["device_type"] = "cpu"
        with pytest.raises(Exception, match="monotone_constraints"):
            pkg.train(params, pkg.Dataset(X, label=y), num_boost_round=1)
    with pytest.raises(LightGBMError, match="in regression_l1 objective"):
        lgb.train(dict(BASE, objective="regression_l1", device_type="cpu",
                       monotone_constraints=MC),
                  lgb.Dataset(X, label=y), num_boost_round=1)


@pytest.mark.parametrize("extra", [{}, {"use_quantized_grad": True},
                                   {"monotone_penalty": 1.5,
                                    "max_depth": 5}],
                         ids=["f32", "quantized8", "penalty_max_depth"])
def test_basic_whole_tree_equals_per_split(extra):
    X, y = _data()
    params = dict(BASE, device_type="cpu", monotone_constraints=MC,
                  **extra)
    runs = [lgb.train(dict(params, tpu_fused_tree=fused),
                      lgb.Dataset(X, label=y), num_boost_round=3)
            for fused in (True, False)]
    assert runs[0].inner.learner.grow_stats["record_reads"] == 3
    assert runs[1].inner.learner.grow_stats["record_reads"] == 0
    assert [t.to_string() for t in runs[0].inner.models] == \
        [t.to_string() for t in runs[1].inner.models]
    assert torch.equal(runs[0].inner.train_score.view(torch.int32),
                       runs[1].inner.train_score.view(torch.int32))


def test_record_layout_of_a_monotone_categorical_learner():
    """Trap: the four bound columns come after the categorical ones, and
    a monotone row is not read as categorical."""
    lay = S.RecordLayout(64, True, True)
    assert lay.width == S.record_width(64, True) + 4
    assert lay.bounds == S.record_width(64, True)
    assert lay.cat_words == slice(S.CAT_WORDS, S.CAT_WORDS + 4)
    plain = S.RecordLayout(64, False, True)
    assert plain.bounds == S.RECORD_WIDTH and plain.width == 18
    from lightgbm_tpu_torch.treelearner.serial import SplitRecord
    # a monotone row is as long as a categorical one of 4 mask words
    row = [1.0, 2.0, 3.0, 0.0] + [0.5] * 10 + [1.0, 1.0, -2.0, 2.0]
    assert len(row) == S.record_width(48, True)
    rec = SplitRecord.from_row(0, row, plain)
    assert not rec.is_categorical and rec.cat_mask is None
    rec = SplitRecord.from_row(0, row, S.RecordLayout(48, True, False))
    assert rec.is_categorical and rec.cat_mask.shape == (48,)
