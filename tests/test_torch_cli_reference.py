"""The port's CLI (``python -m lightgbm_tpu_torch.application``) against
the JAX package's CLI (``lightgbm_tpu/application.py``) on the CPU.

- ``task=train`` on each ``examples/*/train.conf`` (binary, regression,
  multiclass, lambdarank): the two models at level (b) (the same
  splits and leaf counts, leaf values within f32 tolerance) tree by
  tree, up to the first split where the two learners part, if any. That
  split must be a near-tie: the gains the two learners chose agree
  within 1e-4 relative, the rounding of two f32 histogram sums in
  different orders (the port's plain CPU histogram and the JAX
  package's). From there on the trees grow on different scores and are
  not compared tree by tree. The binary, regression and multiclass
  confs part at such a split (tree 0 node 25, tree 20 node 25 and tree
  0 node 13 on this CPU); lambdarank is level (b) throughout. The whole models are
  then held on the conf's test set: mean |prediction gap| within
  ``PRED_GAP`` and the held-out loss (binary log loss, l2, multiclass
  log loss) within ``LOSS_GAP`` relative. Readings on this CPU: binary
  0.0102 and 0.28%, regression 5.0e-10 and 2e-11, multiclass 0.00031
  and 0.036%, lambdarank 2.0e-7 (level (b) to the end);
- on one model file (the JAX CLI's): ``task=predict`` outputs within
  1e-12 (values, raw scores, leaf indices, an iteration slice),
  ``task=refit`` at level (b) at two decay rates, ``task=convert_model``
  byte-equal C++;
- ``task=save_binary``: the same bins, mappers, labels and query
  boundaries (each package reads its own container back).
"""
import os
import shutil

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu import application as ref_app
from lightgbm_tpu_torch.application import _load_tabular, run
from lightgbm_tpu_torch.config import Config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
BINARY = os.path.join(EXAMPLES, "binary_classification")
CPU = {"device_type": "cpu"}
#: relative gap of two chosen gains that is still the rounding of two
#: f32 histogram sums in different orders
NEAR_TIE = 1e-4
#: bounds on the whole models after a near-tie: the mean absolute gap of
#: the two CLIs' test-set predictions, and the relative gap of their
#: held-out losses (about 2x and 3.5x the largest reading, binary's)
PRED_GAP = 0.02
LOSS_GAP = 0.01


def _trees(path):
    return lgb.Booster(model_file=path, params=CPU).inner.models


def _same_split(a, b, i):
    return (a.split_feature[i] == b.split_feature[i]
            and a.threshold[i] == b.threshold[i])


def _assert_level_b(ref_path, port_path, near_tie_ok=False):
    """Level (b) tree by tree; with ``near_tie_ok``, up to the first
    parting split, which must be a near-tie. Returns where the models
    parted, (tree, node), or None."""
    ref, port = _trees(ref_path), _trees(port_path)
    assert len(ref) == len(port)
    for t, (a, b) in enumerate(zip(ref, port)):
        ni = a.num_internal
        if near_tie_ok:
            for i in range(min(ni, b.num_internal)):
                if not _same_split(a, b, i):
                    ga, gb = float(a.split_gain[i]), float(b.split_gain[i])
                    assert abs(ga - gb) <= NEAR_TIE * max(abs(ga), abs(gb)), \
                        "tree %d node %d: gains %r and %r" % (t, i, ga, gb)
                    return t, i
        assert (a.num_leaves, a.split_feature[:ni].tolist(),
                a.threshold[:ni].tolist(),
                a.leaf_count[:a.num_leaves].tolist()) == \
            (b.num_leaves, b.split_feature[:ni].tolist(),
             b.threshold[:ni].tolist(),
             b.leaf_count[:b.num_leaves].tolist()), "tree %d" % t
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6,
                                   err_msg="tree %d" % t)
    return None


def _logloss(p, y):
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def _multi_logloss(p, y):
    return float(-np.mean(np.log(np.clip(
        p[np.arange(len(y)), y.astype(int)], 1e-15, 1))))


_HELD_OUT_LOSS = {
    "binary_classification": _logloss,
    "regression": lambda p, y: float(np.mean((p - y) ** 2)),
    "multiclass_classification": _multi_logloss,
}


@pytest.mark.parametrize("directory,train,test", [
    ("binary_classification", "binary.train", "binary.test"),
    ("regression", "regression.train", "regression.test"),
    ("multiclass_classification", "multiclass.train", "multiclass.test"),
    ("lambdarank", "rank.train", "rank.test"),
])
def test_cli_train_matches_the_reference_cli(directory, train, test,
                                             tmp_path):
    d = os.path.join(EXAMPLES, directory)
    common = ["config=" + os.path.join(d, "train.conf"),
              "data=" + os.path.join(d, train),
              "valid_data=" + os.path.join(d, test), "verbosity=-1"]
    port, ref = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    assert run(common + ["output_model=" + port, "device_type=cpu"]) == 0
    assert ref_app.run(common + ["output_model=" + ref]) == 0
    parted = _assert_level_b(ref, port, near_tie_ok=True)
    if directory == "lambdarank":
        assert parted is None
    X, y, _, _ = _load_tabular(os.path.join(d, test), Config.from_params({}))
    pp, pr = (lgb.Booster(model_file=m, params=CPU).predict(X)
              for m in (port, ref))
    gap = float(np.mean(np.abs(pp - pr)))
    assert gap <= PRED_GAP, (parted, gap)
    loss = _HELD_OUT_LOSS.get(directory)
    if loss is not None:
        lp, lr = loss(pp, y), loss(pr, y)
        assert abs(lp - lr) <= LOSS_GAP * abs(lr), (parted, lp, lr)


@pytest.fixture(scope="module")
def ref_model(tmp_path_factory):
    """The binary example trained by the JAX package's CLI (5 trees)."""
    path = str(tmp_path_factory.mktemp("cli") / "ref.txt")
    assert ref_app.run(["config=" + os.path.join(BINARY, "train.conf"),
                        "data=" + os.path.join(BINARY, "binary.train"),
                        "valid_data=" + os.path.join(BINARY, "binary.test"),
                        "num_trees=5", "verbosity=-1",
                        "output_model=" + path]) == 0
    return path


def test_cli_predict_matches_the_reference_cli(ref_model, tmp_path):
    outs = {who: str(tmp_path / (who + ".tsv")) for who in ("port", "ref")}
    data = os.path.join(BINARY, "binary.test")
    for extra in ([], ["predict_raw_score=true"],
                  ["predict_leaf_index=true"],
                  ["num_iteration_predict=3", "start_iteration_predict=1"]):
        argv = ["task=predict", "data=" + data, "input_model=" + ref_model,
                "verbosity=-1"] + extra
        assert run(argv + ["output_result=" + outs["port"],
                           "device_type=cpu"]) == 0
        assert ref_app.run(argv + ["output_result=" + outs["ref"]]) == 0
        np.testing.assert_allclose(np.loadtxt(outs["port"]),
                                   np.loadtxt(outs["ref"]), rtol=1e-12,
                                   atol=1e-12, err_msg=str(extra))


@pytest.mark.parametrize("decay", ["0.9", "0.3"])
def test_cli_refit_matches_the_reference_cli(ref_model, tmp_path, decay):
    outs = [str(tmp_path / (who + ".txt")) for who in ("port", "ref")]
    argv = ["task=refit", "data=" + os.path.join(BINARY, "binary.test"),
            "input_model=" + ref_model, "refit_decay_rate=" + decay,
            "verbosity=-1"]
    assert run(argv + ["output_model=" + outs[0], "device_type=cpu"]) == 0
    assert ref_app.run(argv + ["output_model=" + outs[1]]) == 0
    assert _assert_level_b(outs[1], outs[0]) is None
    # the refit moved the leaves
    assert not np.array_equal(_trees(outs[0])[0].leaf_value,
                              _trees(ref_model)[0].leaf_value)


def test_cli_convert_model_matches_the_reference_cli(ref_model, tmp_path):
    outs = [str(tmp_path / (who + ".cpp")) for who in ("port", "ref")]
    argv = ["task=convert_model", "input_model=" + ref_model,
            "convert_model_language=cpp", "verbosity=-1"]
    assert run(argv + ["convert_model=" + outs[0], "device_type=cpu"]) == 0
    assert ref_app.run(argv + ["convert_model=" + outs[1]]) == 0
    with open(outs[0]) as a, open(outs[1]) as b:
        assert a.read() == b.read()


def test_cli_save_binary_matches_the_reference_cli(tmp_path):
    from lightgbm_tpu.io.binary_io import load_binary as ref_load
    from lightgbm_tpu_torch.io.binary_io import load_binary
    data = {}
    for who in ("port", "ref"):
        os.makedirs(tmp_path / who)
        data[who] = str(tmp_path / who / "rank.train")
        shutil.copy(os.path.join(EXAMPLES, "lambdarank", "rank.train"),
                    data[who])
        shutil.copy(os.path.join(EXAMPLES, "lambdarank", "rank.train.query"),
                    data[who] + ".query")
    argv = ["task=save_binary", "objective=lambdarank", "max_bin=63",
            "verbosity=-1"]
    assert run(argv + ["data=" + data["port"], "device_type=cpu"]) == 0
    assert ref_app.run(argv + ["data=" + data["ref"]]) == 0
    port, ref = load_binary(data["port"] + ".bin"), ref_load(
        data["ref"] + ".bin")
    np.testing.assert_array_equal(np.asarray(port.bins),
                                  np.asarray(ref.bins))
    assert list(port.used_feature_map) == list(ref.used_feature_map)
    for a, b in zip(port.bin_mappers, ref.bin_mappers):
        assert a.to_dict() == b.to_dict()
    np.testing.assert_array_equal(port.metadata.label, ref.metadata.label)
    np.testing.assert_array_equal(port.metadata.query_boundaries,
                                  ref.metadata.query_boundaries)
