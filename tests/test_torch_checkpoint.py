"""Crash-consistent checkpoint/resume of the port
(``lightgbm_tpu_torch/ft/checkpoint.py``, ``lgb.train(checkpoint_dir=,
checkpoint_freq=, resume=)``) on the CPU.

- A run that checkpoints every 2 rounds and is cut (an exception from a
  callback) after its 4-round checkpoint, then resumed, gives the model
  text of the uninterrupted run and its training scores bit for bit
  (level a). Cases: f32; 8-bit quantized with bagging; GOSS; DART;
  feature_fraction; early stopping cut and resumed inside its patience
  window (the same best iteration and stopping point).
- A truncated, or a poisoned (same size, other bytes), newest checkpoint
  is skipped with a ``checkpoint_invalid`` event and the run resumes from
  the one before; a finalize that fails once under the fault spec is
  retried (``io_retry``) and the run still resumes bit for bit.
- The directory is the JAX package's format v2: the same file names,
  manifest keys and state keys (level a on the key sets).
- What the reference refuses (CEGB's cross-tree state), the port refuses
  with the same message.
"""
import json
import os

import numpy as np
import pytest

import lightgbm_tpu as ref_lgb

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.obs import events, faults
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = {"device_type": "cpu"}
BASE = {"objective": "binary", "num_leaves": 7, "verbose": -1,
        "min_data_in_leaf": 10, "learning_rate": 0.3}
CASES = {
    "f32": {},
    "quantized8-bagging": {"use_quantized_grad": True,
                           "quant_grad_bits": 8, "bagging_fraction": 0.7,
                           "bagging_freq": 1},
    "goss": {"data_sample_strategy": "goss"},
    "dart": {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.0},
    "feature_fraction": {"feature_fraction": 0.6},
    "early_stopping": {"early_stopping_round": 4, "metric": "auc"},
}


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.reset()
    events.register_event_callback(None)


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(1500, 8)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(1500) > 0).astype(float)
    # a noisy held-out set: its AUC peaks at iteration 3 and early
    # stopping (patience 4) fires at iteration 7
    r2 = np.random.RandomState(102)
    Xv = r2.randn(300, 8)
    yv = (Xv[:, 0] + 0.5 * Xv[:, 1] + 3 * r2.randn(300) > 0).astype(float)
    return X, y, Xv, yv


class _Cut(Exception):
    pass


def _cut_at(iteration):
    """An after-iteration callback that kills the run at ``iteration``
    (0-based): its tree is trained, its checkpoint never written."""
    def cb(env):
        if env.iteration == iteration:
            raise _Cut()
    cb.order = 40
    return cb


def _run(params, rounds, valid, pkg=lgb, **kw):
    X, y, Xv, yv = _data()
    tr = pkg.Dataset(X, label=y)
    vs = [pkg.Dataset(Xv, label=yv, reference=tr)] if valid else None
    return pkg.train(params, tr, rounds, valid_sets=vs, **kw)


def _bits(bst):
    return bst.inner.train_score.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cut_and_resumed_run_is_the_uninterrupted_one(case, tmp_path):
    params = dict(BASE, **CASES[case], **CPU)
    es = case == "early_stopping"
    rounds = 12 if es else 6
    full = _run(params, rounds, es)
    d = str(tmp_path / "ck")
    with pytest.raises(_Cut):
        _run(params, rounds, es, checkpoint_dir=d, checkpoint_freq=2,
             callbacks=[_cut_at(4)])
    assert sorted(os.listdir(d)) == ["ckpt-00000002", "ckpt-00000004"]
    seen = []
    events.register_event_callback(seen.append)
    resumed = _run(params, rounds, es, checkpoint_dir=d, checkpoint_freq=2,
                   resume=True)
    assert resumed.model_to_string() == full.model_to_string()
    np.testing.assert_array_equal(_bits(resumed), _bits(full))
    assert resumed.best_iteration == full.best_iteration
    resumes = [r for r in seen if r["event"] == "checkpoint_resumed"]
    assert [(r["iter"], r["score_replay"]) for r in resumes] == [(4, "ok")]
    if es:
        # the best iteration lies before the cut and the stop after it:
        # the resumed run continued the saved patience window
        assert full.best_iteration == 3
        assert full.current_iteration == 7


def _trained_dir(tmp_path, rounds=6):
    params = dict(BASE, **CPU)
    d = str(tmp_path / "ck")
    _run(params, rounds, False, checkpoint_dir=d, checkpoint_freq=2)
    return params, d


@pytest.mark.parametrize("damage", ["truncated", "poisoned"])
def test_damaged_newest_checkpoint_is_skipped(damage, tmp_path):
    params, d = _trained_dir(tmp_path)
    target = os.path.join(d, "ckpt-00000006", "score.npy")
    data = open(target, "rb").read()
    with open(target, "wb") as f:
        if damage == "truncated":
            f.write(data[:len(data) // 2])
        else:
            f.write(data[:-8] + bytes(8 * [0x5A]))
    seen = []
    events.register_event_callback(seen.append)
    resumed = _run(params, 8, False, checkpoint_dir=d, resume=True)
    invalid = [r for r in seen if r["event"] == "checkpoint_invalid"]
    assert len(invalid) == 1 and invalid[0]["path"].endswith("ckpt-00000006")
    assert ("truncated" if damage == "truncated" else "content hash") \
        in invalid[0]["reason"]
    assert [r["iter"] for r in seen
            if r["event"] == "checkpoint_resumed"] == [4]
    full = _run(params, 8, False)
    assert resumed.model_to_string() == full.model_to_string()
    np.testing.assert_array_equal(_bits(resumed), _bits(full))


def test_finalize_fault_is_retried_and_resume_stays_exact(tmp_path):
    params = dict(BASE, **CPU)
    d = str(tmp_path / "ck")
    seen = []
    events.register_event_callback(seen.append)
    faults.configure("checkpoint_finalize:nth:2")
    with pytest.raises(_Cut):
        _run(params, 6, False, checkpoint_dir=d, checkpoint_freq=2,
             callbacks=[_cut_at(4)])
    faults.reset()
    kinds = [r["event"] for r in seen]
    assert kinds.count("fault_injected") == 1 and "io_retry" in kinds
    assert sorted(os.listdir(d)) == ["ckpt-00000002", "ckpt-00000004"]
    resumed = _run(params, 6, False, checkpoint_dir=d, resume=True)
    full = _run(params, 6, False)
    assert resumed.model_to_string() == full.model_to_string()
    np.testing.assert_array_equal(_bits(resumed), _bits(full))


def _layout(d):
    path = os.path.join(d, sorted(os.listdir(d))[-1])
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    state = json.load(open(os.path.join(path, "state.json")))
    nested = {k: sorted(v) for k, v in state.items() if isinstance(v, dict)}
    return (sorted(os.listdir(path)), sorted(manifest),
            sorted(manifest["files"]), sorted(state), nested,
            manifest["format_version"], state["format_version"])


def test_directory_layout_is_the_references_format_v2(tmp_path):
    params = dict(BASE, use_quantized_grad=True, quant_grad_bits=8,
                  bagging_fraction=0.7, bagging_freq=1,
                  early_stopping_round=4, metric="auc")
    port_d, ref_d = str(tmp_path / "port"), str(tmp_path / "ref")
    _run(dict(params, **CPU), 4, True, checkpoint_dir=port_d,
         checkpoint_freq=2)
    _run(params, 4, True, pkg=ref_lgb, checkpoint_dir=ref_d,
         checkpoint_freq=2)
    port, ref = _layout(port_d), _layout(ref_d)
    assert port == ref
    assert port[5] == 2 and "engine" in port[3]


def test_cegb_refused_with_the_references_message(tmp_path):
    params = dict(BASE, cegb_penalty_split=0.1)
    msgs = []
    for pkg, extra in ((lgb, CPU), (ref_lgb, {})):
        with pytest.raises(Exception) as ei:
            _run(dict(params, **extra), 2, False, pkg=pkg,
                 checkpoint_dir=str(tmp_path / pkg.__name__),
                 checkpoint_freq=1)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "CEGB" in msgs[0]
    with pytest.raises(LightGBMError):
        _run(dict(params, **CPU), 1, False,
             checkpoint_dir=str(tmp_path / "again"), checkpoint_freq=1)
