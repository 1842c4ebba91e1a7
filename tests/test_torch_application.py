"""The port's CLI (``lightgbm_tpu_torch/application.py``) on the CPU.

- every case of the JAX package's ``tests/test_consistency.py``: the four
  ``examples/*/train.conf`` (binary, regression, multiclass, lambdarank)
  trained through the CLI and through ``lgb.train``, test-set
  predictions within 1e-9, and the ``predict`` task against
  ``Booster.predict``; all with ``device_type=cpu``;
- the ``train`` task's ``cli_train_done`` summary event (its learner's
  trees, roots, steps and captures, and the launches since it started);
- ``parse_args`` gives the JAX package's precedence (the command line
  over the config file, the first value of each source);
- every CLI key of the config (task, the network keys, the column
  keys, ``convert_model*``, ``predict_*``, ``*_iteration_predict``,
  ``refit_decay_rate``), through its aliases, field by field against
  the JAX package's ``Config``;
- the distributed CLI's rank resolution (local IP, then
  ``local_listen_port``) and backend rule;
- no fallback: without ``device_type=cpu`` the CLI asks for the card
  and raises here; the distributed backend is chosen by the layout.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import application as app
from lightgbm_tpu_torch.application import (_load_tabular, _sidecar,
                                            parse_args, run)
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
CPU = {"device_type": "cpu"}


class FileLoader:
    """reference: test_consistency.py FileLoader."""

    def __init__(self, directory, prefix, tmp_path):
        self.directory = os.path.join(EXAMPLES, directory)
        self.prefix = prefix
        self.tmp = str(tmp_path)
        self.params = parse_args(
            ["config=" + os.path.join(self.directory, "train.conf")])
        # paths in conf are relative to the example dir
        for key in ("data", "valid", "valid_data"):
            if key in self.params:
                self.params[key] = os.path.join(self.directory,
                                                self.params[key])
        self.params["output_model"] = os.path.join(self.tmp, "model.txt")
        self.params["verbosity"] = "-1"
        self.params["device_type"] = "cpu"

    def train_cli(self):
        rc = run(["%s=%s" % (k, v) for k, v in self.params.items()])
        assert rc == 0
        return self.params["output_model"]

    def load(self, name):
        cfg = Config.from_params({k: v for k, v in self.params.items()
                                  if k not in ("config",)})
        path = os.path.join(self.directory, self.prefix + name)
        X, y, w, g = _load_tabular(path, cfg)
        if g is None:
            g = _sidecar(path, "query")
        return X, y, w, g


CASES = [
    ("binary_classification", "binary.", "binary"),
    ("regression", "regression.", "regression"),
    ("multiclass_classification", "multiclass.", "multiclass"),
    ("lambdarank", "rank.", "lambdarank"),
]


@pytest.mark.parametrize("directory,prefix,objective", CASES)
def test_cli_matches_python(directory, prefix, objective, tmp_path):
    fl = FileLoader(directory, prefix, tmp_path)
    model_path = fl.train_cli()
    assert os.path.exists(model_path)
    cli_bst = lgb.Booster(model_file=model_path, params=CPU)

    # train the same config through the Python API
    X, y, w, g = fl.load("train")
    params = {k: v for k, v in fl.params.items()
              if k not in ("config", "task", "data", "valid", "valid_data",
                           "output_model", "num_trees", "num_iterations")}
    n_rounds = int(fl.params.get("num_trees",
                                 fl.params.get("num_iterations", 10)))
    ds = lgb.Dataset(X, label=y, weight=w, group=g, params=params)
    api_bst = lgb.train(params, ds, num_boost_round=n_rounds)

    Xt, _, _, _ = fl.load("test")
    np.testing.assert_allclose(cli_bst.predict(Xt), api_bst.predict(Xt),
                               rtol=1e-9, atol=1e-12)


def test_cli_predict_task(tmp_path):
    fl = FileLoader("binary_classification", "binary.", tmp_path)
    model_path = fl.train_cli()
    out = os.path.join(str(tmp_path), "preds.txt")
    rc = run(["task=predict", "device_type=cpu",
              "data=" + os.path.join(fl.directory, "binary.test"),
              "input_model=" + model_path,
              "output_result=" + out])
    assert rc == 0
    preds = np.loadtxt(out)
    bst = lgb.Booster(model_file=model_path, params=CPU)
    Xt, _, _, _ = fl.load("test")
    np.testing.assert_allclose(preds, bst.predict(Xt), rtol=1e-9)
    assert np.all((preds >= 0) & (preds <= 1))


def test_cli_train_emits_its_summary(tmp_path):
    """With events on, ``task=train`` ends with one ``cli_train_done``
    event: the trees, roots, steps and captures of its learner (those of
    ``lgb.train`` on the same conf) and the kernel launches since the
    task started, none on the CPU."""
    from lightgbm_tpu_torch.obs import events
    fl = FileLoader("binary_classification", "binary.", tmp_path)
    seen = []
    events.register_event_callback(seen.append)
    try:
        fl.train_cli()
    finally:
        events.register_event_callback(None)
    done = [e for e in seen if e["event"] == "cli_train_done"]
    assert len(done) == 1
    d = done[0]
    X, y, w, g = fl.load("train")
    params = {k: v for k, v in fl.params.items()
              if k not in ("config", "task", "data", "valid", "valid_data",
                           "output_model", "num_trees", "num_iterations")}
    n_rounds = int(fl.params["num_trees"])
    api = lgb.train(params, lgb.Dataset(X, label=y, weight=w, group=g,
                                        params=params),
                    num_boost_round=n_rounds)
    st = api.inner.learner.grow_stats
    assert (d["trees"], d["roots"], d["steps"], d["captures"]) == \
        (n_rounds, st["roots"], st["steps"], st["captures"])
    assert d["roots"] == n_rounds and d["steps"] > 0
    assert d["launches"] and not any(d["launches"].values())
    assert d["load_seconds"] > 0 and d["train_seconds"] > 0


def test_cli_without_a_card_raises(tmp_path):
    """The CLI runs on the card unless the arguments say
    device_type=cpu; without a card it raises, as lgb.train does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: cuda is allowed here")
    data = os.path.join(EXAMPLES, "binary_classification", "binary.train")
    for task in ("train", "predict"):
        with pytest.raises(LightGBMError, match="no CUDA device"):
            run(["task=" + task, "data=" + data,
                 "input_model=" + str(tmp_path / "m.txt"),
                 "output_model=" + str(tmp_path / "m.txt")])


def test_parse_args_precedence_matches_the_reference(tmp_path):
    """The command line wins over the config file; within each source
    the first value of a key wins; comments and quotes are stripped."""
    from lightgbm_tpu.application import parse_args as ref_parse
    conf = tmp_path / "a.conf"
    conf.write_text("# comment\nnum_trees = 7\nnum_trees = 9\n"
                    "objective = 'binary'  # trailing\nlearning_rate=0.3\n"
                    "noequals\n")
    argv = ["config=%s" % conf, "learning_rate=0.05", "learning_rate=0.9",
            "--max_bin=15", 'output_model="m.txt"', "stray"]
    got = parse_args(argv)
    assert got == ref_parse(argv)
    assert (got["num_trees"], got["objective"], got["learning_rate"],
            got["max_bin"], got["output_model"]) == \
        ("7", "binary", "0.05", "15", "m.txt")


CLI_KEYS = ["task", "machines", "machine_list_filename",
            "local_listen_port", "num_machines", "pre_partition", "header",
            "label_column", "weight_column", "group_column",
            "ignore_column", "convert_model", "convert_model_language",
            "predict_raw_score", "predict_leaf_index", "predict_contrib",
            "predict_disable_shape_check", "output_result",
            "start_iteration_predict", "num_iteration_predict",
            "refit_decay_rate", "input_model", "output_model", "data",
            "valid"]

CLI_CASES = [
    {},
    {"task": "predict"},
    {"task_type": "refit", "refit_decay_rate": "0.25"},
    {"task": "convert_model", "convert_model_language": "cpp",
     "convert_model": "out.cpp"},
    {"machines": "10.0.0.1:12400,10.0.0.2:12400", "num_machines": "2",
     "local_listen_port": "12400"},
    {"workers": "127.0.0.1:1", "num_machine": 2, "local_port": 7},
    {"machine_list_file": "mlist.txt", "port": "9"},
    {"mlist": "m2.txt", "nodes": "a:1"},
    {"pre_partition": "true", "header": "true"},
    {"is_pre_partition": True, "has_header": False},
    {"label_column": "name:y", "weight_column": "2", "group_column": "3",
     "ignore_column": "4,5"},
    {"label": "1", "weight": "name:w", "query": "0",
     "ignore_feature": "name:a,name:b"},
    {"group_id": "2", "blacklist": "7"},
    {"predict_raw_score": "true", "predict_leaf_index": "true",
     "predict_contrib": "true", "predict_disable_shape_check": "true"},
    {"is_predict_raw_score": True, "leaf_index": True, "contrib": True},
    {"start_iteration_predict": "2", "num_iteration_predict": "5"},
    {"predict_result": "r.txt", "model_in": "i.txt", "model_out": "o.txt"},
    {"train": "t.csv", "valid_data": "v1.csv,v2.csv"},
]


@pytest.mark.parametrize("params", CLI_CASES,
                         ids=lambda p: ",".join(sorted(p)) or "defaults")
def test_cli_config_fields_match_reference(params):
    from lightgbm_tpu.config import Config as RefConfig
    ref = RefConfig.from_params(dict(params))
    port = Config.from_params(dict(params))
    for name in CLI_KEYS:
        assert getattr(port, name) == getattr(ref, name), name
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        if f.name in ("raw_params", "device_type") or \
                f.name not in ref_fields:
            continue
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("device,ranks,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 2, 2, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 2, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 4, 2, "gloo"),
])
def test_distributed_backend_follows_the_layout(monkeypatch, device, ranks,
                                                cards, want):
    """gloo for CPU ranks; NCCL when each rank on this host has its own
    card; gloo when ranks on this host share a card. Decided from the
    layout alone, before any group starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, why = app._backend(Config.from_params({"device_type": device}),
                                ranks)
    assert backend == want and why


def test_rank_resolution(tmp_path):
    """Local entries are told apart by local_listen_port; an entry that
    is not local is never this machine."""
    mlist = tmp_path / "mlist.txt"
    mlist.write_text("127.0.0.1 5001\n127.0.0.1 5002\n")
    for port, rank in ((5001, 0), (5002, 1)):
        cfg = Config.from_params({"num_machines": 2, "local_listen_port":
                                  port, "machine_list_file": str(mlist)})
        got, entries, on_host = app._resolve_rank(cfg)
        assert (got, entries, on_host) == \
            (rank, [("127.0.0.1", 5001), ("127.0.0.1", 5002)], [0, 1])
    cfg = Config.from_params({"num_machines": 2, "local_listen_port": 5003,
                              "machines": "127.0.0.1:5001,127.0.0.1:5002"})
    with pytest.raises(LightGBMError, match="cannot identify"):
        app._resolve_rank(cfg)
    cfg = Config.from_params({"num_machines": 3,
                              "machines": "127.0.0.1:5001,127.0.0.1:5002"})
    with pytest.raises(LightGBMError, match="machine list has 2"):
        app._resolve_rank(cfg)
