"""Import hygiene and device rules of the PyTorch/CUDA port.

- ``lightgbm_tpu_torch`` and ``chip_smoke.py`` import neither jax nor any
  module of ``lightgbm_tpu`` (checked in a fresh interpreter and by a
  source scan);
- every module file of the JAX package has a counterpart at the same
  path, and every public name of its ``serve``, ``parallel``, ``loop``,
  ``native`` and ``application`` one in the port's, but those recorded
  in ``NO_COUNTERPART_MODULES`` and ``NO_COUNTERPART`` with their
  reason;
- ``device_type="cuda"`` (the default) without a visible GPU raises
  instead of running on the CPU;
- every setting ``lgb.train`` does not run raises and names what runs it
  (or its ROADMAP item), and the settings of the later slices train
  (those of items 16, 17 and 26 against the JAX package);
- ``chip_smoke.py`` fails without a GPU and prints no result.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_fresh_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys, runpy\n"
        "import lightgbm_tpu_torch, lightgbm_tpu_torch.convert\n"
        "import lightgbm_tpu_torch.csrc\n"
        "from lightgbm_tpu_torch import (cv, CVBooster, LGBMClassifier,\n"
        "    LGBMRegressor, LGBMRanker, plot_importance, plot_metric,\n"
        "    plot_split_value_histogram, plot_tree, create_tree_digraph)\n"
        "import lightgbm_tpu_torch.io.streaming, lightgbm_tpu_torch.io.binary_io\n"
        "import lightgbm_tpu_torch.models.shap, lightgbm_tpu_torch.models.codegen\n"
        "import lightgbm_tpu_torch.utils.atomic\n"
        "import lightgbm_tpu_torch.obs, lightgbm_tpu_torch.ft.checkpoint\n"
        "from lightgbm_tpu_torch.obs import (compile, events, export,\n"
        "    faults, gateway, health, openmetrics, quality, registry,\n"
        "    trace, trace_compact)\n"
        "import lightgbm_tpu_torch.utils.retry, lightgbm_tpu_torch.utils.timer\n"
        "import lightgbm_tpu_torch.utils.locktrace\n"
        "from lightgbm_tpu_torch.serve import (server, replicate,\n"
        "    PredictServer, ModelRegistry, ReplicatedForest)\n"
        "import lightgbm_tpu_torch.io.shards\n"
        "import lightgbm_tpu_torch.treelearner.sharded\n"
        "import lightgbm_tpu_torch.loop, lightgbm_tpu_torch.application\n"
        "import lightgbm_tpu_torch.native, lightgbm_tpu_torch.native.capi\n"
        "runpy.run_path(%r, run_name='chip_smoke_imported')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.'))\n"
        "print('BAD', bad)\n" % os.path.join(ROOT, "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.MULTILINE)


def test_sources_import_no_jax_and_no_reference_package():
    offenders = []
    for path in _sources():
        with open(path) as fh:
            for mod in _IMPORT.findall(fh.read()):
                top = mod.split(".")[0]
                if top in ("jax", "jaxlib", "lightgbm_tpu"):
                    offenders.append((os.path.relpath(path, ROOT), mod))
    assert offenders == []


#: public names of the JAX package's modules that the port leaves
#: without a counterpart, with the reason
NO_COUNTERPART = {
    ("lightgbm_tpu.serve", "compile_predict_with_plan"):
        "builds one jit/pjit (or shard_map) program over a device mesh; "
        "eager PyTorch compiles no program: ReplicatedForest walks one "
        "row block per device instead",
}


#: module files of the JAX package that the port leaves without a
#: counterpart, with the reason
NO_COUNTERPART_MODULES = {
    "utils/scalars.py":
        "explicit JAX device scalars for the transfer guard; the port's "
        "captured step takes no host scalars "
        "(test_torch_fused_growth.py::test_split_step_makes_no_host_read)",
    "ops_refresh.py":
        "refresh_learner_params is treelearner/serial.py::reset_config, "
        "which boosting/gbdt.py::reset_config calls",
}


def _public_names(module):
    """A module's ``__all__``, else the functions and classes it
    defines itself."""
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return [n for n, v in vars(module).items() if not n.startswith("_")
            and getattr(v, "__module__", None) == module.__name__]


@pytest.mark.parametrize("module", ["serve", "parallel", "loop", "native",
                                    "native.capi", "application"])
def test_reference_exports_have_counterparts(module):
    """Every name the JAX package's ``serve``, ``parallel``, ``loop``,
    ``native`` and ``application`` export exists in the port's, except
    those recorded in NO_COUNTERPART (which must not)."""
    import importlib
    ref = importlib.import_module("lightgbm_tpu." + module)
    port = importlib.import_module("lightgbm_tpu_torch." + module)
    missing = sorted(n for n in _public_names(ref) if not hasattr(port, n))
    expected = sorted(n for (m, n) in NO_COUNTERPART
                      if m == "lightgbm_tpu." + module)
    assert missing == expected


def test_every_reference_module_has_a_counterpart():
    """Every module file of ``lightgbm_tpu/`` has one at the same path in
    ``lightgbm_tpu_torch/``, except those recorded in
    NO_COUNTERPART_MODULES (which must not)."""
    ref_root = os.path.join(ROOT, "lightgbm_tpu")
    missing = []
    for dirpath, _, files in os.walk(ref_root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ref_root)
                if not os.path.exists(os.path.join(PKG, rel)):
                    missing.append(rel.replace(os.sep, "/"))
    assert sorted(missing) == sorted(NO_COUNTERPART_MODULES)


def _tiny():
    rng = np.random.RandomState(0)
    X = rng.randn(300, 4)
    return X, (X[:, 0] > 0).astype(float)


@pytest.mark.parametrize("params", [{}, {"device_type": "cuda"},
                                    {"device": "gpu"},
                                    {"use_quantized_grad": True}])
def test_cuda_without_a_gpu_raises(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: cuda is allowed here")
    X, y = _tiny()
    with pytest.raises(LightGBMError, match="no CUDA device"):
        lgb.train(dict(params, objective="binary", verbose=-1),
                  lgb.Dataset(X, label=y), num_boost_round=1)


@pytest.mark.parametrize("quantized", [False, True])
def test_cpu_runs_only_when_asked(quantized):
    X, y = _tiny()
    bst = lgb.train({"objective": "binary", "device_type": "cpu",
                     "use_quantized_grad": quantized, "verbose": -1},
                    lgb.Dataset(X, label=y), num_boost_round=2)
    assert bst.inner.device.type == "cpu"
    assert bst.inner.learner.bins.device.type == "cpu"
    assert Config.from_params({}).device_type == "cuda"
    assert Config.from_params({"device": "gpu"}).device_type == "cuda"


@pytest.mark.parametrize("params", [
    {"boosting": "goss"},
    {"data_sample_strategy": "goss"},
    {"feature_fraction": 0.5},
    {"extra_trees": True},
    {"feature_fraction_bynode": 0.5},
    {"use_quantized_grad": True, "feature_fraction": 0.5},
    {"interaction_constraints": "[0,1],[2,3]"},
    {"cegb_penalty_split": 0.1},
])
def test_sampling_and_node_filters_train(params):
    """Settings of the sampling slice train on the CPU and give a valid
    model text (they raised before the slice)."""
    X, y = _tiny()
    bst = lgb.train(dict({"objective": "binary", "device_type": "cpu",
                          "verbose": -1, "learning_rate": 0.5}, **params),
                    lgb.Dataset(X, label=y), num_boost_round=3)
    text = bst.model_to_string()
    assert text.startswith("tree") and "end of trees" in text
    again = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), bst.predict(X))


@pytest.mark.parametrize("params", [
    {"monotone_constraints": "1,-1,0,0"},
    {"monotone_constraints": [1, -1, 0, 0],
     "monotone_constraints_method": "intermediate"},
    {"mc": [1, -1, 0, 0], "monotone_constraints_method": "advanced"},
    {"monotone_constraints": [1, 0, 0, 1], "monotone_penalty": 1.0},
    {"linear_tree": True, "linear_lambda": 0.5},
    {"forcedsplits_filename": "FORCED"},
], ids=["monotone", "intermediate", "advanced", "penalty", "linear",
        "forced"])
def test_monotone_forced_linear_train_save_load(params, tmp_path):
    """Monotone constraints, forced splits and linear trees train, save,
    load and predict (they raised before this slice)."""
    if params.get("forcedsplits_filename") == "FORCED":
        path = tmp_path / "forced.json"
        path.write_text('{"feature": 1, "threshold": 0.0}')
        params = {"forcedsplits_filename": str(path)}
    X, y = _tiny()
    bst = lgb.train(dict({"objective": "binary", "device_type": "cpu",
                          "verbose": -1, "learning_rate": 0.5}, **params),
                    lgb.Dataset(X, label=y), num_boost_round=3)
    text = bst.model_to_string()
    assert text.startswith("tree") and "end of trees" in text
    again = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), bst.predict(X))
    assert ("is_linear=1" in text) == ("linear_tree" in params)


@pytest.mark.parametrize("params,item", [
    ({"categorical_feature": "0", "max_bin": 300}, None),
    ({"tpu_eval_iterations": 4}, None),
    ({"num_machines": 2}, "lightgbm_tpu_torch.application"),
    ({"num_gpu": 2}, "mesh_shape"),
    ({"gpu_use_dp": True}, None),
    ({"boosting": "dart"}, None),
    ({"objective": "none"}, "item 18"),
    ({"boosting": "rf", "bagging_fraction": 0.8, "bagging_freq": 1}, None),
    ({"max_bin": 511}, None),
    ({"tpu_use_f64_hist": True}, None),
    ({"tpu_batch_iterations": 4}, None),
    ({"tree_learner": "data", "mesh_shape": "data=8"}, None),
])
def test_settings_outside_the_slice_raise(params, item):
    """A setting ``lgb.train`` does not run raises naming what runs it
    (``num_machines``: the CLI; ``num_gpu``: ``mesh_shape``), or its
    ROADMAP item. The settings
    of items 16, 17 and 26 (wide bins, f64 histograms, DART, RF, batched
    iterations and eval hoisting), which raised before the port had
    them, train and give the JAX package's trees on the verify-skill rows (2000 x 10; column 0 holds 300
    categories for the categorical case; 15 leaves), at level (b): the same splits
    and leaf counts, predictions within 1e-6. So does ``tree_learner=data``
    (item 22), on 8 shards in both packages (the JAX package's 8 forced
    host devices). ``gpu_use_dp`` asks the
    port for f64 histograms; the reference reads only
    ``tpu_use_f64_hist``, so it is held to that (under x64, which the
    reference's f64 path needs)."""
    params = dict({"objective": "binary", "verbose": -1}, **params)
    if item is not None:
        X, y = _tiny()
        with pytest.raises(LightGBMError, match=item):
            lgb.train(dict(params, device_type="cpu"),
                      lgb.Dataset(X, label=y), num_boost_round=1)
        return
    params["num_leaves"] = 15
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 10)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    if "categorical_feature" in params:
        X[:, 0] = rng.randint(0, 300, 2000)
        y = ((X[:, 0] % 3 == 0) ^ (X[:, 1] > 0)).astype(float)
    import jax
    import lightgbm_tpu as ref_lgb
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=3)
    ref_params = dict(params)
    if ref_params.pop("gpu_use_dp", False):
        ref_params["tpu_use_f64_hist"] = True
    with jax.enable_x64(bool(ref_params.get("tpu_use_f64_hist"))):
        ref = ref_lgb.train(ref_params, ref_lgb.Dataset(X, label=y),
                            num_boost_round=3)
    assert len(port.inner.models) == len(ref.inner.models) == 3
    for a, b in zip(ref.inner.models, port.inner.models):
        ni = a.num_internal
        assert (a.num_leaves, a.split_feature[:ni].tolist(),
                a.threshold[:ni].tolist(),
                a.leaf_count[:a.num_leaves].tolist()) == \
            (b.num_leaves, b.split_feature[:ni].tolist(),
             b.threshold[:ni].tolist(),
             b.leaf_count[:b.num_leaves].tolist())
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["scatter", "onehot"])
def test_hist_backend_other_than_the_kernel_raises(backend):
    with pytest.raises(LightGBMError, match="hist_backend"):
        Config.from_params({"hist_backend": backend})


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, cwd=cwd, timeout=120,
                             env={k: v for k, v in os.environ.items()
                                  if k != "PYTHONPATH"})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
