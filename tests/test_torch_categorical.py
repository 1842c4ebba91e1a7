"""Categorical features in the port against the JAX package, on the CPU.

The same seeded numpy inputs go to ``lightgbm_tpu`` and to
``lightgbm_tpu_torch`` (``device_type="cpu"``). Levels (ROADMAP):

- (a) byte-equal: the categorical bin mappers and bins (NaN, negative and
  unseen values, the 99% cutoff, rare categories, more categories than
  ``max_cat_threshold``); the text of trees replayed from the reference
  learner's own split records; the text round trip;
- the split scan on the same histograms: the same winner, variant and
  left-bin mask exactly, the gain within rtol 1e-5 (level b; the scan
  order is the reference's, so it is byte-equal on these inputs);
- (b) the flows of ``tests/test_categorical.py`` (regression, binary,
  one-hot mode, sorted subset): every tree makes the same splits with the
  same leaf counts and category sets, leaf values within rtol 1e-4.
  The regression flow (31 leaves over 10 categories) is held to the
  same row partition in every tree, with each row's leaf value within
  rtol 1e-4, but not to the same node order (ROADMAP queue 3): a leaf
  holding two categories has two mirrored candidates of equal gain in
  exact arithmetic ({A} left by the forward scan, {B} left by the
  reverse one); their f32 gains differ by rounding (the reference's
  histogram order and fused multiply-adds), so either package may take
  either one, and the two give the same rows left and right swapped;
- predictions of NaN, negative and unseen categories equal to the
  reference's host walk (level a: the same trees, carried across).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lightgbm_tpu as ref_lgb
import lightgbm_tpu.config as ref_config
import lightgbm_tpu.io.dataset as ref_dataset
import lightgbm_tpu.ops.split as ref_split
import lightgbm_tpu.treelearner.serial as ref_serial
from lightgbm_tpu.models.tree import Tree as RefTree
import lightgbm_tpu_torch as lgb
import lightgbm_tpu_torch.config as port_config
import lightgbm_tpu_torch.io.dataset as port_dataset
import lightgbm_tpu_torch.ops.split as port_split
from lightgbm_tpu_torch.convert import bin_mappers_from_numpy, \
    trees_from_numpy
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.treelearner import serial as port_serial

torch.set_num_threads(1)


def _cat_data(n=2000, n_cats=10, seed=0):
    """tests/test_categorical.py's data: a shuffled-effect category and
    one numeric column."""
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, n_cats, n).astype(np.float64)
    x1 = rng.randn(n)
    effect = rng.randn(n_cats) * 2.0
    y = effect[cat.astype(int)] + 0.3 * x1 + 0.1 * rng.randn(n)
    return np.column_stack([cat, x1]), y


def _mapper_fixture(kind: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    n = 3000
    X = np.empty((n, 4))
    X[:, 0] = rng.randint(0, 12, n)
    # a long tail: 60 categories with geometric shares (the 99% cutoff
    # and the min_data_in_bin drop)
    p = 0.85 ** np.arange(60)
    X[:, 1] = rng.choice(60, n, p=p / p.sum())
    X[:, 2] = rng.randint(0, 3, n) * 7        # sparse category values
    X[:, 3] = rng.randn(n)
    params = {"verbose": -1}
    if kind == "nan_negative":
        X[rng.rand(n) < 0.1, 0] = np.nan
        X[rng.rand(n) < 0.05, 0] = -3
        X[rng.rand(n) < 0.05, 2] = -1
    if kind == "fractional":
        X[:, 0] += 0.25                       # truncated to the integer
    if kind == "many":
        X[:, 0] = rng.randint(0, 120, n)      # > max_cat_threshold, > 64
    if kind == "sampled":
        params["bin_construct_sample_cnt"] = 800
    return X, params


def _both_datasets(X, params, cats, y=None):
    label = np.zeros(len(X)) if y is None else y
    ref = ref_dataset.BinnedDataset.from_matrix(
        X, ref_config.Config.from_params(params), label=label,
        categorical_feature=cats)
    port = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params(dict(params, device_type="cpu")),
        label=label, categorical_feature=cats)
    return ref, port


@pytest.mark.parametrize("kind", ["plain", "nan_negative", "fractional",
                                  "many", "sampled"])
def test_categorical_mappers_byte_equal(kind):
    """Level (a): every mapper's fields (``to_dict``) and the binned
    matrix; unseen values (never sampled, or new) go to bin 0."""
    X, params = _mapper_fixture(kind)
    ref, port = _both_datasets(X, params, [0, 1, 2])
    assert ref.used_feature_map == port.used_feature_map
    for a, b in zip(ref.bin_mappers, port.bin_mappers):
        assert a.to_dict() == b.to_dict()
        assert a.feature_info() == b.feature_info()
    assert port.bins.tobytes() == ref.bins.tobytes()
    probe = np.array([np.nan, -1.0, -0.5, 0.0, 2.9, 999.0, 1e12])
    for a, b in zip(ref.bin_mappers[:3], port.bin_mappers[:3]):
        np.testing.assert_array_equal(a.value_to_bin(probe),
                                      b.value_to_bin(probe))
        assert b.value_to_bin(999.0) == 0
    m = port.bin_mappers[1]
    # the 99% cutoff drops the tail's rarest categories into bin 0
    assert m.num_bin - 1 < len(np.unique(X[:, 1]))


def test_mappers_carried_across_and_by_name():
    """``convert.bin_mappers_from_numpy`` takes categorical mappers; the
    port's Dataset takes categorical columns by name too."""
    X, params = _mapper_fixture("nan_negative", seed=2)
    ref, _ = _both_datasets(X, params, [0, 2])
    dicts = [None] * X.shape[1]
    for j, f in enumerate(ref.used_feature_map):
        dicts[f] = ref.bin_mappers[j].to_dict()
    port = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params({"device_type": "cpu"}),
        mappers=bin_mappers_from_numpy(dicts))
    assert port.bins.tobytes() == ref.bins.tobytes()
    named = lgb.Dataset(X, label=np.zeros(len(X)),
                        feature_name=["a", "b", "c", "d"],
                        categorical_feature=["a", "c"],
                        params={"device_type": "cpu", "verbose": -1})
    assert named.handle.bins.tobytes() == ref.bins.tobytes()


# ----------------------------------------------------------------------
# the split scan on the same histograms
# ----------------------------------------------------------------------
F, B = 8, 32
SCAN_PARAMS = [
    {},
    {"min_data_per_group": 1, "cat_smooth": 1.0},
    {"min_data_per_group": 50, "max_cat_threshold": 4},
    {"max_cat_to_onehot": 8, "min_data_in_leaf": 5},
    {"cat_l2": 1.0, "lambda_l1": 2.0, "path_smooth": 5.0},
]


def _scan_case(seed, onehot):
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, F).astype(np.int32)
    is_cat = rng.rand(F) < 0.6
    is_cat[0] = True
    cnt = rng.randint(0, 60, (F, B)).astype(np.float32)
    cnt[np.arange(B)[None, :] >= num_bin[:, None]] = 0
    g = (rng.randn(F, B) * cnt).astype(np.float32)
    h = (rng.rand(F, B) * cnt).astype(np.float32)
    hist = np.stack([g, h, cnt, cnt], -1)
    return hist, hist[0].sum(0), num_bin, is_cat, \
        is_cat & (num_bin <= onehot)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("params", SCAN_PARAMS,
                         ids=lambda p: ",".join(p) or "default")
def test_scan_same_winner_and_mask(seed, params):
    params = dict(params, verbose=-1)
    rc = ref_config.Config.from_params(params)
    pc = port_config.Config.from_params(dict(params, device_type="cpu"))
    hist, tot, num_bin, is_cat, onehot = _scan_case(
        seed, pc.max_cat_to_onehot)
    zeros = np.zeros(F, dtype=np.int32)
    rmeta = ref_split.FeatureMeta(
        num_bin=jnp.asarray(num_bin), missing_type=jnp.asarray(zeros),
        zero_bin=jnp.asarray(zeros), is_categorical=jnp.asarray(is_cat),
        use_onehot=jnp.asarray(onehot), monotone=jnp.zeros(F, jnp.int8))
    pmeta = port_split.FeatureMeta(
        num_bin=torch.from_numpy(num_bin),
        missing_type=torch.from_numpy(zeros),
        zero_bin=torch.from_numpy(zeros),
        is_categorical=torch.from_numpy(is_cat),
        use_onehot=torch.from_numpy(onehot),
        cat_positions=int((num_bin[is_cat] // 2).max()))
    parent = 0.05
    ref = ref_split.find_best_split(
        jnp.asarray(hist), *[jnp.float32(v) for v in tot], rmeta,
        ref_split.SplitParams.from_config(rc), jnp.ones(F, dtype=bool),
        parent_output=jnp.float32(parent), has_categorical=True)
    row = port_split.find_best_split(
        torch.from_numpy(hist), *[torch.tensor(v) for v in tot], pmeta,
        port_split.SplitParams.from_config(pc, torch.device("cpu")),
        torch.ones(F, dtype=torch.bool), torch.tensor(parent,
                                                      dtype=torch.float32),
        has_categorical=True).tolist()
    assert len(row) == port_split.record_width(B, True)
    assert int(row[port_split.FEATURE]) == int(ref.feature)
    assert int(row[port_split.THRESHOLD_BIN]) == int(ref.threshold_bin)
    assert bool(row[port_split.IS_CATEGORICAL]) == bool(ref.is_categorical)
    assert bool(row[port_split.DEFAULT_LEFT]) == bool(ref.default_left)
    np.testing.assert_array_equal(port_split.cat_mask_of_row(row, B),
                                  np.asarray(ref.cat_mask))
    for col, name in ((port_split.GAIN, "gain"),
                      (port_split.LEFT_SUM_GRAD, "left_sum_grad"),
                      (port_split.LEFT_COUNT, "left_count"),
                      (port_split.LEFT_OUTPUT, "left_output"),
                      (port_split.RIGHT_OUTPUT, "right_output")):
        np.testing.assert_allclose(row[col], float(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6)


def test_scan_of_numerical_features_keeps_its_record():
    """``has_categorical=False`` (every all-numerical learner) keeps the
    14-column record; with categorical features off the wider scan
    picks the same numerical split."""
    hist, tot, num_bin, _, _ = _scan_case(3, 4)
    zeros = np.zeros(F, dtype=np.int32)
    meta = port_split.FeatureMeta(
        num_bin=torch.from_numpy(num_bin),
        missing_type=torch.from_numpy(zeros),
        zero_bin=torch.from_numpy(zeros),
        is_categorical=torch.zeros(F, dtype=torch.bool),
        use_onehot=torch.zeros(F, dtype=torch.bool))
    pp = port_split.SplitParams.from_config(
        port_config.Config.from_params({"device_type": "cpu"}),
        torch.device("cpu"))
    args = (torch.from_numpy(hist), *[torch.tensor(v) for v in tot], meta,
            pp, torch.ones(F, dtype=torch.bool), torch.tensor(0.0))
    plain = port_split.find_best_split(*args)
    wide = port_split.find_best_split(*args, has_categorical=True)
    assert plain.shape == (port_split.RECORD_WIDTH,)
    assert torch.equal(wide[:port_split.RECORD_WIDTH], plain)
    assert float(wide[port_split.IS_CATEGORICAL]) == 0.0


def test_cat_mask_packing_round_trips():
    rng = np.random.RandomState(0)
    for nb in (2, 16, 17, 256):
        mask = torch.from_numpy(rng.rand(nb) < 0.4)
        words = port_split.pack_cat_mask(mask)
        assert torch.equal(port_split.unpack_cat_mask(words, nb), mask)
        row = [0.0] * port_split.CAT_WORDS + words.tolist()
        np.testing.assert_array_equal(port_split.cat_mask_of_row(row, nb),
                                      mask.numpy())


# ----------------------------------------------------------------------
# training flows (tests/test_categorical.py) at level (b)
# ----------------------------------------------------------------------
def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.decision_type[:ni].tolist(), tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist(),
            list(tree.cat_boundaries), list(tree.cat_threshold))


def _binary_data(n=2000, seed=7):
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, 8, n).astype(np.float64)
    pos_rate = np.array([0.9, 0.1, 0.8, 0.2, 0.7, 0.3, 0.95, 0.05])
    y = (rng.rand(n) < pos_rate[cat.astype(int)]).astype(np.float64)
    return np.column_stack([cat, rng.randn(n)]), y


FLOWS = {
    "regression": (lambda: _cat_data(),
                   {"objective": "regression", "min_data_in_leaf": 20}),
    "sorted_subset": (lambda: _cat_data(n_cats=20, seed=3),
                      {"objective": "regression", "num_leaves": 8,
                       "min_data_in_leaf": 20}),
    "onehot": (lambda: _cat_data(n_cats=3, seed=5),
               {"objective": "regression", "min_data_in_leaf": 20}),
    "binary": (_binary_data,
               {"objective": "binary", "min_data_in_leaf": 20}),
    "quantized8": (lambda: _cat_data(seed=4),
                   {"objective": "regression", "min_data_in_leaf": 20,
                    "use_quantized_grad": True}),
}
#: flows held to the same row partitions only (see the module docstring)
MIRRORED = {"regression"}


def _partition(leaves: np.ndarray) -> np.ndarray:
    """[n, T] leaf ids -> each row's first row in its leaf: equal arrays
    are the same partition, whatever the leaves' numbering."""
    out = np.empty_like(leaves)
    for t in range(leaves.shape[1]):
        _, first, inv = np.unique(leaves[:, t], return_index=True,
                                  return_inverse=True)
        out[:, t] = first[inv.reshape(-1)]
    return out


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_flow_trees_match_reference(flow):
    make, params = FLOWS[flow]
    X, y = make()
    params = dict(params, verbose=-1)
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y,
                                                categorical_feature=[0]),
                        num_boost_round=3)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y, categorical_feature=[0]),
                     num_boost_round=3)
    assert any(t.num_cat > 0 for t in port.inner.models)
    if flow in MIRRORED:
        ref_leaf = np.asarray(ref.predict(X, pred_leaf=True))
        port_leaf = port.predict(X, pred_leaf=True, predict_on_device=False)
        np.testing.assert_array_equal(_partition(port_leaf),
                                      _partition(ref_leaf))
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        if flow in MIRRORED:
            assert a.num_leaves == b.num_leaves, "tree %d differs" % i
            np.testing.assert_allclose(b.leaf_value[port_leaf[:, i]],
                                       a.leaf_value[ref_leaf[:, i]],
                                       rtol=1e-4, atol=1e-6)
            continue
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.predict(X, predict_on_device=False),
                               ref.predict(X), rtol=1e-4, atol=1e-5)


def _records_of_reference(X, y, params, rounds=3):
    """Train the reference and keep every split record its learner
    replayed, as numpy values, tree by tree."""
    trees, cur = [], []
    real = ref_serial.apply_split_record

    def spy(tree, dataset, rec):
        if not cur or cur[-1][0] is not tree:
            cur.append((tree, []))
        cur[-1][1].append({k: np.asarray(v) for k, v
                           in rec._asdict().items()})
        return real(tree, dataset, rec)
    ref_serial.apply_split_record = spy
    try:
        ds = ref_lgb.Dataset(X, label=y, categorical_feature=[0])
        bst = ref_lgb.train(params, ds, num_boost_round=rounds)
    finally:
        ref_serial.apply_split_record = real
    trees = [recs for _, recs in cur]
    return bst, ds.handle, trees


def test_text_of_trees_replayed_from_the_reference_records():
    """Level (a): the reference learner's own split records, replayed
    into a reference Tree and (as the port's SplitRecord) into a port
    Tree over the same bin mappers, give byte-equal tree text."""
    X, y = _cat_data(n_cats=20, seed=3)
    X[::11, 0] = np.nan
    params = {"objective": "regression", "num_leaves": 12, "verbose": -1,
              "min_data_in_leaf": 10}
    _, ref_ds, per_tree = _records_of_reference(X, y, params)
    dicts = [None] * X.shape[1]
    for j, f in enumerate(ref_ds.used_feature_map):
        dicts[f] = ref_ds.bin_mappers[j].to_dict()
    port_ds = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params({"device_type": "cpu"}),
        mappers=bin_mappers_from_numpy(dicts))
    B = 1 << max(int(port_ds.max_num_bin) - 1, 1).bit_length()
    n_cat = 0
    for recs in per_tree:
        rt = RefTree(params["num_leaves"])
        pt = Tree(params["num_leaves"])
        for r in recs:
            ref_serial.apply_split_record(rt, ref_ds, ref_serial.SplitRecord(
                **{k: jnp.asarray(v) for k, v in r.items()}))
            mask = np.zeros(B, dtype=bool)
            mask[:len(r["cat_mask"])] = r["cat_mask"][:B]
            rec = port_serial.SplitRecord(
                int(r["leaf"]), float(r["gain"]), int(r["feature"]),
                int(r["threshold_bin"]), bool(r["default_left"]),
                *[float(r[k]) for k in (
                    "left_sum_grad", "left_sum_hess", "left_count",
                    "left_total_count", "left_output", "right_sum_grad",
                    "right_sum_hess", "right_count", "right_total_count",
                    "right_output")],
                bool(r["is_categorical"]), mask)
            port_serial.apply_split_record(pt, port_ds, rec)
        n_cat += pt.num_cat
        assert pt.to_string() == rt.to_string()
    assert n_cat > 0


def test_model_text_round_trip():
    """Level (a): the port's categorical model text parses back (its
    own parser and the reference's) to the same text and the same
    predictions."""
    X, y = _cat_data()
    X[::13, 0] = np.nan
    port = lgb.train({"objective": "regression", "verbose": -1,
                      "device_type": "cpu"},
                     lgb.Dataset(X, label=y, categorical_feature=[0]),
                     num_boost_round=5)
    text = port.model_to_string()
    assert "cat_threshold=" in text and "cat_boundaries=" in text
    again = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    trees = text.split("end of trees")[0]
    assert again.model_to_string().split("end of trees")[0] == trees
    np.testing.assert_array_equal(again.predict(X), port.predict(X))
    ref = ref_lgb.Booster(model_str=text)
    np.testing.assert_array_equal(ref.predict(X), port.predict(X))
    node = port.dump_model()["tree_info"][0]["tree_structure"]
    assert node["decision_type"] == "=="


def test_unusual_categories_predict_like_the_reference():
    """NaN, negative, fractional and unseen categories: the port's host
    walk (and its stacked forest on the CPU) gives the reference's host
    walk's values on the same trees (level a)."""
    X, y = _cat_data()
    X[::9, 0] = np.nan
    ref = ref_lgb.train({"objective": "regression", "verbose": -1},
                        ref_lgb.Dataset(X, label=y,
                                        categorical_feature=[0]),
                        num_boost_round=8)
    port = lgb.Booster(model_str=ref.model_to_string(),
                       params={"device_type": "cpu"})
    rng = np.random.RandomState(1)
    Xq = np.column_stack([
        rng.choice([np.nan, -1.0, -7.0, -0.5, 0.0, 3.0, 3.7, 9.0, 10.0,
                    31.0, 32.0, 999.0], 400), rng.randn(400)])
    want = ref.predict(Xq)
    np.testing.assert_array_equal(port.predict(Xq, predict_on_device=False),
                                  want)
    np.testing.assert_array_equal(port.predict(Xq, predict_on_device=True),
                                  want)
    carried = trees_from_numpy([dict(
        num_leaves=t.num_leaves, shrinkage=t.shrinkage,
        num_cat=t.num_cat, cat_boundaries=t.cat_boundaries,
        cat_threshold=t.cat_threshold,
        **{k: getattr(t, k) for k in (
            "split_feature", "threshold", "threshold_in_bin",
            "decision_type", "left_child", "right_child", "leaf_value")})
        for t in ref.inner.models])
    got = sum(t.predict(Xq) for t in carried)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_categorical_stops_raising():
    """``categorical_feature`` no longer raises (it was item 11); the
    setting reaches the Dataset through params too."""
    X, y = _cat_data(n=500)
    cfg = port_config.Config.from_params({"categorical_feature": "0",
                                          "device_type": "cpu"})
    cfg.check_slice()
    bst = lgb.train({"objective": "regression", "verbose": -1,
                     "device_type": "cpu", "categorical_feature": "0"},
                    lgb.Dataset(X, label=y), num_boost_round=2)
    assert bst.inner.train_data.bin_mappers[0].bin_type == 1


def test_continued_training_from_categorical_text():
    """``init_model`` from categorical model text: the loaded trees get
    their bin masks from the new dataset's mappers
    (``GBDT.align_trees_to_dataset``), so their binned replay onto the
    training scores gives the host walk's raw scores."""
    X, y = _cat_data(seed=6)
    X[::15, 0] = np.nan
    params = {"objective": "regression", "verbose": -1,
              "device_type": "cpu", "num_leaves": 15}
    first = lgb.train(params, lgb.Dataset(X, label=y,
                                          categorical_feature=[0]),
                      num_boost_round=3)
    loaded = lgb.Booster(model_str=first.model_to_string(),
                         params={"device_type": "cpu"})
    cont = lgb.train(params, lgb.Dataset(X, label=y,
                                         categorical_feature=[0]),
                     num_boost_round=2, init_model=loaded)
    assert cont.num_trees() == 5
    np.testing.assert_allclose(
        cont.predict(X, raw_score=True, num_iteration=3),
        first.predict(X, raw_score=True), rtol=1e-12)
    # the training scores: the replayed 3 trees plus 2 new ones
    np.testing.assert_allclose(
        cont.inner.train_score.numpy()[:, 0],
        cont.predict(X, raw_score=True, predict_on_device=False),
        rtol=0, atol=1e-5)
